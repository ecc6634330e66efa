"""The port's training driver with ``--expert-parallel 2`` on two gloo ranks
of the CPU (dp = 1, ep = 2), in each capacity dispatch mode that runs an
expert-parallel form: ``capacity`` (the sharded scatter buffers),
``capacity_fused`` (the psum form) and ``capacity_fused_a2a`` (the
all-to-all form; its permuted-tile form, the checkpoint and ``--resume``
are in ``tests/test_torch_ep_checkpoint.py``). Every rank exits 0, the
losses are finite, the dense parameters are bit-identical over the ranks
after the epoch (the driver checks and prints their digest), and only
rank 0 writes the checkpoint and the log."""
import json
import math

import pytest
from ep_driver_common import SMALL, run_ranks
from torch_tmp import delete_module_tmp, delete_tmp_path  # noqa: F401


@pytest.mark.parametrize("dispatch", ["capacity", "capacity_fused",
                                      "capacity_fused_a2a"])
def test_driver_runs_each_ep_dispatch(dispatch, tmp_path):
    outs = run_ranks(SMALL + ["--expert-parallel", "2", "--moe-dispatch",
                              dispatch], 2, tmp_path)
    assert "dense parameters bit-identical over 2 rank(s)" in outs[0]
    log = [json.loads(line) for line in open(tmp_path / "log.txt")]
    assert len(log) == 1 and math.isfinite(log[0]["train_loss"])
    assert 0.0 <= log[0]["train_drop_fraction"] < 1.0
    assert (tmp_path / "checkpoint").exists()
    assert "Averaged stats" not in outs[1]  # rank 1 prints nothing more
