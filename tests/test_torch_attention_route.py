"""The port's attention routing (``models/vit.py::attention_route``) and
the paths at long N, against the JAX package.

- The route table, one case a row: K11 for ``use_flash`` in eval, the
  plain attention for ``use_flash`` in training, the plain attention with
  dropout under ``attn_drop`` in training, the plain attention beyond
  N = 1024 (JAX's XLA branch), K5 in eval and K5 + K6 in training up to
  N = 1024.
- A Block at N = 577 (ViT-S/16 at 384 px; D = 128, 2 heads of 64, a dense
  MLP) in f32, forward and backward, against the JAX Block on the CPU
  (whose ``_fused_ok`` takes its XLA branch there; on the TPU it runs its
  kernels): the port trains it on the K5 + K6 route, whose plain versions
  run on the CPU. Output and every gradient within 1e-5 of max |ref| (the
  same f32 products in other orders).
- Attention dropout in training acts on the probabilities, as the JAX XLA
  branch applies it: at rate 1 every probability is dropped, so the
  attention output is zero and the module returns the proj bias; at 0.5
  the mean over draws approaches the eval output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.models.vit import Block as JaxBlock
from slim_switch_moe_vit_tpu_torch.models import vit
from slim_switch_moe_vit_tpu_torch.models.layers import Mlp
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import from_jax_params



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (N, training, attn_drop, use_flash) -> route
ROUTES = [
    ((197, False, 0.0, True), "flash"),
    ((197, True, 0.0, True), "plain"),
    ((197, True, 0.1, False), "plain_dropout"),
    ((197, False, 0.1, False), "k5"),
    ((1025, False, 0.0, False), "plain"),
    ((1025, True, 0.0, False), "plain"),
    ((197, False, 0.0, False), "k5"),
    ((577, False, 0.0, False), "k5"),
    ((1024, False, 0.0, False), "k5"),
    ((197, True, 0.0, False), "k5_k6"),
    ((577, True, 0.0, False), "k5_k6"),
]


@pytest.mark.parametrize("args,route", ROUTES,
                         ids=[f"{r}-{a[0]}-{i}" for i, (a, r) in enumerate(ROUTES)])
def test_attention_route_table(args, route):
    assert vit.attention_route(*args) == route


def test_block_at_577_tokens_matches_jax():
    B, N, D, heads = 1, 577, 128, 2
    rs = np.random.RandomState(0)
    x = rs.randn(B, N, D).astype(np.float32)
    ct = rs.randn(B, N, D).astype(np.float32)
    block = JaxBlock(dim=D, num_heads=heads, mlp_ratio=1.0)
    params = block.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    @jax.jit
    def fwd_bwd(params, x, ct):
        y, vjp = jax.vjp(lambda p, x: block.apply({"params": p}, x), params,
                         x)
        return y, vjp(ct)

    y_ref, (dp_ref, dx_ref) = fwd_bwd(params, jnp.asarray(x), jnp.asarray(ct))

    port = vit.Block(D, heads, Mlp(D, D))
    port.load_state_dict(from_jax_params(params))
    port.train()
    vit.ROUTE_COUNTS.clear()
    xt = torch.from_numpy(x).requires_grad_()
    y = port(xt)
    y.backward(torch.from_numpy(ct))
    assert dict(vit.ROUTE_COUNTS) == {"k5_k6": 1}

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=what)

    close(y.detach().numpy(), y_ref, "y")
    close(xt.grad.numpy(), dx_ref, "dx")
    grads = from_jax_params(jax.tree.map(np.asarray, dp_ref))
    for name, p in port.named_parameters():
        close(p.grad.numpy(), grads[name].numpy(), name)


def test_attention_dropout_acts_on_the_probabilities():
    torch.manual_seed(0)
    D, heads = 128, 2
    attn = vit.Attention(D, heads, attn_drop=1.0)
    gen = torch.Generator().manual_seed(1)
    for p in attn.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.1
    x = torch.randn(2, 17, D, generator=gen)
    vit.ROUTE_COUNTS.clear()
    y = attn.train()(x)
    assert dict(vit.ROUTE_COUNTS) == {"plain_dropout": 1}
    torch.testing.assert_close(y, attn.proj.bias.expand_as(y), rtol=0,
                               atol=0)
    attn.attn_drop = 0.5
    with torch.no_grad():
        want = attn.eval()(x)
        attn.train()
        mean = sum(attn(x) for _ in range(400)) / 400
    assert (mean - want).abs().max() < 0.1 * want.abs().max()
    assert (attn(x) - want).abs().max() > 0.1 * want.abs().max()
