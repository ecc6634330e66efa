"""The check on the CPU: a run of each cell at a tiny size, past the
harness's look for a card, comes out correct; with the timed path broken
underneath, or the fp8 control in the program's place, it does not.

Faults: a training step that returns its state unchanged, a step that
leaves half of the batch out (the mean taken over the rest), and a served
answer altered where it is produced. The cells run on one card, so there
is no exchange between cards to leave out."""
from __future__ import annotations

import pytest
import torch
from portbench_tiny import tiny_run

from portbench import check, harness
from portbench.traffic import serve, train

TRAIN = "moe_small_e8.train_b512"
SERVE = "moe_small_e8.serve_b128"


@pytest.fixture(autouse=True)
def _no_card_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")


def _correct(workload: str) -> bool:
    line, checks = harness.execute(tiny_run(workload))
    assert list(line)[-1] == "checks" and set(checks) == set(
        harness.load("cells", workload)["limits"])
    return line["correct"]


@pytest.mark.parametrize("workload", [TRAIN, SERVE])
def test_a_sound_run_is_correct(workload):
    assert _correct(workload)


def _broken_step(monkeypatch, wrap):
    from slim_switch_moe_vit_tpu_torch import engine

    make = engine.make_train_step
    monkeypatch.setattr(engine, "make_train_step",
                        lambda *a, **kw: wrap(make, *a, **kw))


def test_a_step_that_returns_its_state_unchanged_is_not_correct(monkeypatch):
    def wrap(make, model, update_fn, *a, **kw):
        return make(model, lambda *x: None, *a, **dict(kw, ema_decay=None))

    _broken_step(monkeypatch, wrap)
    assert not _correct(TRAIN)


def test_a_step_on_half_the_batch_is_not_correct(monkeypatch):
    def wrap(make, *a, **kw):
        step = make(*a, **kw)

        def half(state, images, targets, *lr):
            n = images.shape[0] // 2
            return step(state, images[:n], targets[:n], *lr)

        return half

    _broken_step(monkeypatch, wrap)
    assert not _correct(TRAIN)


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from slim_switch_moe_vit_tpu_torch.serving.export import Predictor

    predict = Predictor.predict

    def altered(self, images):
        out = predict(self, images)
        out[0] = out[1]
        return out

    monkeypatch.setattr(Predictor, "predict", altered)
    assert not _correct(SERVE)


@pytest.mark.parametrize("workload,kind", [(TRAIN, train), (SERVE, serve)])
def test_the_fp8_control_in_the_programs_place_is_not_correct(workload, kind):
    """The reference in fp8 products, in the program's place (its own
    routing followed by the f32 reference), against the cell's limits."""
    numbers = kind.readings(tiny_run(workload), ["control"])["control"]
    ok, _ = check.judge(numbers, harness.load("cells", workload)["limits"])
    assert not ok, numbers
