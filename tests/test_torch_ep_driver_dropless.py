"""The port's training driver with ``--expert-parallel 2`` on two gloo
ranks of the CPU (dp = 1, ep = 2) in the modes that run an expert group
since the dropless modes gather their experts: ``--moe-dispatch fused``
with ``--opt lamb --clip-grad 1.0`` (the optimizer's global norms summed
over the expert group), ``fused`` under ``--drop 0.1`` (training forwards
on the gathered ``'ragged'`` form, every rank drawing the same dropout
masks) and ``expert_choice`` (its buffer split over the ranks). Every
rank exits 0, the losses are finite, and the dense parameters are
bit-identical over the ranks after the epoch (the driver checks and prints
their digest)."""
import json
import math

import pytest
from ep_driver_common import SMALL, run_ranks


@pytest.mark.parametrize("flags", [
    ["--moe-dispatch", "fused", "--opt", "lamb", "--clip-grad", "1.0"],
    ["--moe-dispatch", "fused", "--drop", "0.1"],
    ["--moe-dispatch", "expert_choice"]])
def test_driver_runs_the_mode_under_an_expert_group(flags, tmp_path):
    outs = run_ranks(SMALL + ["--expert-parallel", "2"] + flags, 2, tmp_path)
    assert "dense parameters bit-identical over 2 rank(s)" in outs[0]
    log = [json.loads(line) for line in open(tmp_path / "log.txt")]
    assert len(log) == 1 and math.isfinite(log[0]["train_loss"])
    assert 0.0 <= log[0]["train_drop_fraction"] < 1.0
