"""Observability: TensorBoard scalars and the JSON-lines ``log.txt``.

Port of ``slim_switch_moe_vit_tpu/utils/logging.py`` (a copy; reference
``utils.py:299-319`` ``TensorboardXTracker`` and ``main.py:953-962``). The
TensorBoard writer is optional: without ``tensorboardX`` it does nothing.
"""
from __future__ import annotations

import json
import os
import typing as typ


class TensorboardTracker:
    """reference utils.py:299-319. Degrades to no-op if tensorboardX absent."""

    def __init__(self, log_dir: str):
        try:
            import tensorboardX

            self.writer = tensorboardX.SummaryWriter(log_dir)
        except Exception:
            self.writer = None

    def log_scalar(self, var_name: str, value: float, step: int):
        if self.writer is not None:
            self.writer.add_scalar(var_name, value, step)

    def log_loss(self, loss, step):
        self.log_scalar("loss", loss, step)

    def log_validation_acc(self, acc, step):
        self.log_scalar("validation_acc", acc, step)

    def log_test_acc(self, acc, step):
        self.log_scalar("test_acc", acc, step)

    def log_task_test_acc(self, acc, step):
        self.log_scalar("task_test_acc", acc, step)

    def close(self):
        if self.writer is not None:
            self.writer.close()


def append_log_stats(output_dir: str, stats: typ.Dict, is_main: bool = True):
    """One JSON line per epoch in log.txt (reference main.py:960-962)."""
    if not (output_dir and is_main):
        return
    with open(os.path.join(output_dir, "log.txt"), "a") as f:
        f.write(json.dumps(stats) + "\n")
