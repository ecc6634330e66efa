"""The port's expert-parallel MoE forms on a 1 x 4 (data, expert) layout of
gloo ranks on the CPU, against the JAX package's shard-map forms on a 1 x 4
mesh of the conftest's virtual devices: the psum form
(``moe_forward_fused_ep``), the all-to-all form in its relayout and its
permuted-tile (``SSMV_A2A_PERMUTED=1``, K10's plain version) forms
(``moe_forward_fused_ep_a2a``) and the sharded ``'capacity'`` mode
(``moe_forward`` under GSPMD). The same numpy weights (E=8, D=16, H=32,
top-2) and tokens go to both, at a capacity factor of 0.75 so that pairs
drop. y, ``balance_loss``, ``drop_fraction`` and the gradients of
sum(y * c) + 0.5 * balance_loss by x and by every parameter agree within
2e-5 (f32), and every rank of the expert group holds the same y, dx and
router gradient.
"""
import numpy as np
import pytest
import torch_ep_common as common
from torch_tmp import delete_module_tmp, delete_tmp_path  # noqa: F401

DP, EP, FACTOR, T = 1, 4, 0.75, 256
FORMS = ("psum", "a2a", "a2a_perm", "sharded")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    data = common.inputs(T, seed=3)
    out = common.run_port(tmp_path_factory.mktemp("ep14"), DP, EP, data,
                          [(f, FACTOR) for f in FORMS])
    return data, out


@pytest.mark.parametrize("form", FORMS)
def test_ep_form_matches_jax_mesh(port, form, monkeypatch):
    """y, the aux values and the gradients of sum(y * c) + balance_weight *
    balance_loss equal the JAX mesh's."""
    data, out = port
    key = f"{form}@{FACTOR}"
    want = common.run_jax(form, DP, EP, data, FACTOR, monkeypatch)
    common.assert_matches(out[key], want, key)
    common.assert_expert_group_replicated(out["ranks"], EP, key)
    assert out[key]["drop_fraction"] > 0.02  # real drops exercised


def test_balance_term_moves_the_gradients(monkeypatch):
    """The balance term the parity cases differentiate is not lost in
    their tolerance: it moves JAX's router and x gradients far beyond it."""
    data = common.inputs(T, seed=3)
    with_term = common.run_jax("psum", DP, EP, data, FACTOR, monkeypatch)
    without = common.run_jax("psum", DP, EP, data, FACTOR, monkeypatch,
                             balance_weight=0.0)
    for k in ("drouter_w", "drouter_b", "dx"):
        assert np.abs(with_term[k] - without[k]).max() > 10 * common.TOL, k


def test_a2a_forms_agree_bit_for_bit(port):
    """The relayout + K3/K4 and the permuted-tile (K10) a2a forms compute
    the same sums in the same order per row: identical outputs and
    gradients."""
    _, out = port
    a, b = out[f"a2a@{FACTOR}"], out[f"a2a_perm@{FACTOR}"]
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_spawn_runs_on_the_card_unless_cpu_is_passed():
    """``launch.spawn`` is an entry point: its ranks run on the card unless
    the caller passes ``device="cpu"``, as the CPU helpers here do."""
    import inspect

    from slim_switch_moe_vit_tpu_torch.parallel import launch

    device = inspect.signature(launch.spawn).parameters["device"]
    assert device.kind is inspect.Parameter.KEYWORD_ONLY
    assert device.default == "cuda"
