"""The expert FFN's f32 forms: the reference they are held to on the card,
and the plan of their workspace.

On the card the f32 forms of K3 and K4 (and K9's and K10's, the same
kernels) run in split TF32 and are held to the port's exact-f32 plain
versions (``tests/test_torch_kernels.py``, ``cuda``-marked, and
``chip_smoke.py``). Here on the CPU:

- those plain versions against the JAX package's ``fused_expert_ffn``
  forward and ``jax.vjp`` in f32 (its Pallas kernels K3 and K4 in interpret
  mode, as its own tests run them), on the "edges" layout of the
  ``cuda`` cases: an expert with no token (all-padding tiles, whose dW and
  db are exact zeros) and an expert with a single tile, within the
  port's f32 parity limit 1e-5 of max |want|;
- ``wgrad_splits`` and ``workspace_shapes`` against their stated rules in
  both dtypes (f32 dW tiles of 128 x 128, bf16 of 128 x 256; one dh
  partial row per 128 rows).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.ops import fused_ffn as jax_ffn
from slim_switch_moe_vit_tpu.ops import moe as jax_moe
from slim_switch_moe_vit_tpu_torch.ops import fused_ffn as torch_ffn

E, D, H, T = 4, 32, 64, 300
F32_PARITY = 1e-5


def _close(got, want, what):
    got = got.detach().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(
        got, want, rtol=0, atol=F32_PARITY * max(np.abs(want).max(), 1e-30),
        err_msg=what)


def _edges_case():
    """Every token's first choice is expert 0 (two tiles), its second
    expert 1 but for 20 tokens that take expert 2 (a single tile); expert
    3 gets no token (all-padding tiles: its own and the layout's trailing
    slack tile). The cotangent is zero at padding slots, as the combine
    backward gives it."""
    rs = np.random.RandomState(11)
    eidx = np.stack([np.zeros(T, np.int32), np.ones(T, np.int32)], 1)
    eidx[rs.choice(T, 20, replace=False), 1] = 2
    gather_idx, _, e_of_tile, w_slot, _ = jax_moe.aligned_expert_layout(
        jnp.asarray(eidx), E, gate_w=jnp.ones((T, 2)),
        weight_dtype=jnp.float32)
    eot = np.asarray(e_of_tile)
    assert np.bincount(eot, minlength=E).tolist() == [2, 2, 1, 2]
    real = np.asarray(w_slot) > 0
    assert not real[np.repeat(eot, 256) == E - 1].any()
    xs = (rs.randn(T, D)[np.asarray(gather_idx)]).astype(np.float32)
    dy = (rs.randn(len(xs), D) * real[:, None]).astype(np.float32)
    w = [rs.randn(E, D, H) * 0.05, rs.randn(E, H) * 0.01,
         rs.randn(E, H, D) * 0.05, rs.randn(E, D) * 0.01]
    return xs, [a.astype(np.float32) for a in w], eot, dy


def test_plain_f32_forward_matches_interpreted_k3_on_edges():
    xs, (w1, b1, w2, b2), eot, _ = _edges_case()
    want = jax_ffn.fused_expert_ffn(*(jnp.asarray(a) for a in
                                      (xs, w1, b1, w2, b2, eot)))
    got = torch_ffn.fused_expert_ffn(*(torch.from_numpy(a) for a in
                                       (xs, w1, b1, w2, b2, eot)))
    assert got.dtype == torch.float32
    _close(got, want, "y")


def test_plain_f32_backward_matches_interpreted_k4_on_edges():
    xs, (w1, b1, w2, b2), eot, dy = _edges_case()
    jin = [jnp.asarray(a) for a in (xs, w1, b1, w2, b2)]
    _, vjp = jax.vjp(lambda *a: jax_ffn.fused_expert_ffn(
        *a, jnp.asarray(eot)), *jin)
    want = vjp(jnp.asarray(dy))
    tin = [torch.from_numpy(a).requires_grad_() for a in (xs, w1, b1, w2, b2)]
    y = torch_ffn.fused_expert_ffn(*tin, torch.from_numpy(eot))
    got = torch.autograd.grad(y, tin, torch.from_numpy(dy))
    for name, g, w in zip(["dxs", "dw1", "db1", "dw2", "db2"], got, want):
        _close(g, w, name)
        if name != "dxs":
            assert not g[E - 1].any(), f"{name} of the empty expert"
            assert g[E - 2].abs().max() > 0, f"{name} of the one-tile expert"


def _splits_rule(Tp, D, H, E, tile):
    tiles = 2 * E * math.ceil(D / tile[0]) * math.ceil(H / tile[1])
    return max(1, min(8, math.ceil(2 * 132 / tiles), Tp // 256 // E))


@pytest.mark.parametrize("dtype,tile", [(torch.float32, (128, 128)),
                                        (torch.bfloat16, (128, 256))])
def test_wgrad_splits_follows_its_rule(dtype, tile):
    """Two waves of the dtype's dW tiles on 132 SMs, at most 8, no more
    than an expert's 256-row tiles: the flagship's layouts take none, the
    small-E / small-D layouts of the ``cuda`` split case do, in f32 too."""
    assert torch_ffn.DW_TILE[dtype] == tile
    for Tp in (256, 3072, 14848, 52480, 63488):
        for d, h, e in ((192, 768, 4), (192, 768, 8), (384, 1536, 8),
                        (768, 3072, 4), (768, 3072, 32), (384, 320, 4)):
            assert torch_ffn.wgrad_splits(Tp, d, h, e, dtype) == \
                _splits_rule(Tp, d, h, e, tile), (Tp, d, h, e)
    assert torch_ffn.wgrad_splits(14848, 384, 1536, 8, dtype) == 1
    assert torch_ffn.wgrad_splits(3072, 192, 768, 4, dtype) > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_workspace_shapes_per_dtype(dtype):
    """(Tp, H) dh and g in the activation dtype, one f32 dh partial row per
    128 rows (the dh kernels' row block in both dtypes), and the split
    partials only where the dW products split."""
    for Tp, d, h, e in ((14848, 384, 1536, 8), (3072, 192, 768, 4)):
        shapes = torch_ffn.workspace_shapes(Tp, d, h, e, dtype)
        splits = torch_ffn.wgrad_splits(Tp, d, h, e, dtype)
        assert shapes["dh"] == shapes["g"] == (Tp, h)
        assert shapes["db1"] == (Tp // 128, h)
        assert shapes["dw"] == (None if splits == 1
                                else (splits, 2, e, d * h))
        like = torch.empty(1, dtype=dtype)
        ws_dh, ws_g, ws_db1, ws_dw, n = torch_ffn._workspace(Tp, d, h, e,
                                                             like)
        assert (ws_dh.dtype, ws_g.dtype, ws_db1.dtype) == (
            dtype, dtype, torch.float32)
        assert tuple(ws_db1.shape) == shapes["db1"] and n == splits
        assert (ws_dw is None) == (splits == 1)
