"""The benchmark's plain reference against the port's plain CPU path, at a
tiny width in float32, where the two must agree to rounding: the forward,
the first three training steps as the check reads them, and the served
logits; and the fp8 control, which must not."""
from __future__ import annotations

import pytest
import torch
from portbench_tiny import tiny_run

from portbench import weights
from portbench.reference import model as ref
from portbench.traffic import serve, train

F32_AGREE = 1e-4   # f32 against f32: rounding, summed over 12 blocks
EMA_AGREE = 1e-3   # the EMA's change is ~4e-5 of the parameters' (rounding)


def test_forward_matches_the_port():
    run = tiny_run("moe_small_e8.serve_b128")
    model, _ = serve.build(run)
    x = torch.randn((4, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(x)
    want = ref.forward(weights.make(run.cfg, run.seed, "cpu"), x, run.cfg)
    assert got.shape == want.shape == (4, 10)
    assert float((got - want).abs().max() / want.abs().max()) < F32_AGREE


def test_three_training_steps_match_the_port():
    numbers = train.readings(tiny_run("moe_small_e8.train_b512"),
                             ["program"])["program"]
    assert numbers["ema_gap"] < EMA_AGREE
    for k in ("loss_gap", "grad_gap", "change_gap", "grad_diff"):
        assert numbers[k] < F32_AGREE, (k, numbers)


def test_served_logits_match_the_port():
    numbers = serve.readings(tiny_run("moe_small_e8.serve_b128"),
                             ["program"])["program"]
    assert numbers["logit_err_max"] < F32_AGREE, numbers


def test_the_fp8_control_reads_far_from_the_reference():
    numbers = train.readings(tiny_run("moe_small_e8.train_b512"),
                             ["control"])["control"]
    assert numbers["grad_diff"] > 0.05, numbers
    served = serve.readings(tiny_run("moe_small_e8.serve_b128"),
                            ["control"])["control"]
    assert served["logit_err_median"] > 0.03, served


@pytest.mark.parametrize("micro", [1, 3, 8])
def test_the_reference_step_is_the_same_in_any_block_of_rows(micro):
    run = tiny_run("moe_small_e8.train_b512")
    run.traffic["check_micro_batch"] = micro
    whole = tiny_run("moe_small_e8.train_b512")
    whole.traffic["check_micro_batch"] = 8
    a, b = train.reference_record(run), train.reference_record(whole)
    assert a.losses == pytest.approx(b.losses, rel=1e-5)
    for k, v in b.grad.items():
        assert a.grad[k] == pytest.approx(v, rel=1e-4, abs=1e-9)
