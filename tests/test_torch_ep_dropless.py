"""The port's dropless MoE modes and ``expert_choice`` under expert
parallelism, on a 1 x 4 (data, expert) layout of gloo ranks on the CPU.

The dropless forms (``'fused'``, ``'ragged'``) gather the experts over the
group and run the single-card function on every rank
(``ops/moe.py::moe_forward_gathered``), as GSPMD replicates a Pallas
call's inputs in the JAX package; ``expert_choice`` splits its (E, C, d)
buffer over the group as the sharded ``'capacity'`` mode does. The same
numpy weights (E=8, D=16, H=32, top-2) and tokens as
``tests/test_torch_ep.py`` go to the JAX ragged and expert-choice
functions under a 1 x 4 mesh of the conftest's virtual devices: y, the aux
values and the gradients of sum(y * c) + 0.5 * balance_loss by x and
every parameter agree within 2e-5 (f32), and every rank of the expert
group holds the same y, dx and router gradient. The gathered ``'fused'``
form is bit for bit the single-process ``moe_forward_fused`` on all the
experts (the same function on the same inputs)."""
import numpy as np
import pytest
import torch
import torch_ep_common as common

from slim_switch_moe_vit_tpu_torch.ops import moe as torch_moe

DP, EP, T = 1, 4, 256
RUNS = [("fused", 2.0), ("ragged", 2.0), ("expert_choice", 1.0)]
JAX_FORM = {"fused": "ragged", "ragged": "ragged",
            "expert_choice": "expert_choice"}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    data = common.inputs(T, seed=5)
    out = common.run_port(tmp_path_factory.mktemp("ep_dropless"), DP, EP,
                          data, RUNS)
    return data, out


@pytest.mark.parametrize("form,factor", RUNS)
def test_form_matches_jax_mesh(port, form, factor, monkeypatch):
    data, out = port
    key = f"{form}@{factor}"
    want = common.run_jax(JAX_FORM[form], DP, EP, data, factor, monkeypatch)
    common.assert_matches(out[key], want, key)
    common.assert_expert_group_replicated(out["ranks"], EP, key)


def test_gathered_fused_is_the_single_process_function(port):
    data, out = port
    x = torch.from_numpy(data["x"]).requires_grad_()
    w = {k: torch.from_numpy(data[k]).requires_grad_()
         for k in common.PARAMS}
    y, aux = torch_moe.moe_forward_fused(x, *w.values(), top_k=common.K)
    loss = (y * torch.from_numpy(data["c"])).sum()
    (loss + float(data["balance_weight"]) * aux["balance_loss"]).backward()
    got = out["fused@2.0"]
    assert np.array_equal(got["y"], y.detach().numpy())
    assert np.array_equal(got["dx"], x.grad.numpy())
    for k in common.PARAMS:
        assert np.array_equal(got["d" + k], w[k].grad.numpy()), k
