"""A cell's run at a size the CPU holds, for the tests: the cell's own
files, with the model cut to ``moe_tiny_patch16_224_expert8`` (D 192, 3
heads, 8 experts, 12 blocks) at 32 px and 10 classes, batches of 8, and
the run's device the CPU, where the program takes its plain paths."""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import harness  # noqa: E402

TINY = dict(model="moe_tiny_patch16_224_expert8", img_size=32, embed_dim=192,
            num_heads=3, hidden=768, num_classes=10)
TINY_TRAFFIC = dict(batch=8, check_micro_batch=4, pool_batches=4,
                    warmup_steps=1, pool_blocks=2, check_requests=2,
                    check_block=4, warmup_requests=1)


def tiny_run(workload: str, seed: int = 5, dtype: str = "float32",
             seconds: float = 0.2) -> harness.Run:
    cell = harness.load("cells", workload)
    cfg = harness.load("configs", cell["config"])
    cfg.update(TINY, dtype=dtype)
    traffic = harness.load("traffic", cell["traffic"])
    traffic.update(TINY_TRAFFIC)
    return harness.Run(workload=workload, seed=seed, seconds=seconds,
                       trace=False, cell=cell, cfg=cfg, traffic=traffic,
                       device=torch.device("cpu"),
                       started=time.perf_counter())
