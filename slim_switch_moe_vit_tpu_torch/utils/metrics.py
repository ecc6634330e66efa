"""Metric smoothing + iteration logging, in PyTorch.

The port's own copy of ``slim_switch_moe_vit_tpu/utils/metrics.py``
(``SmoothedValue``/``MetricLogger``, the reference's windowed meters and
``log_every`` generator). Peak device memory comes from
``torch.cuda.max_memory_allocated``; the cross-process sync uses
``torch.distributed`` only when a process group is initialized.
"""
from __future__ import annotations

import datetime
import time
import typing as typ
from collections import defaultdict, deque

import numpy as np
import torch


def _device_max_mem_mb() -> typ.Optional[float]:
    """Peak CUDA memory allocated in MB, or None without an initialized
    CUDA context."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return torch.cuda.max_memory_allocated() / (1024.0 * 1024.0)


class SmoothedValue:
    """Track a series of values; smoothed window stats + global average."""

    def __init__(self, window_size: int = 20, fmt: typ.Optional[str] = None):
        if fmt is None:
            fmt = "{median:.4f} ({global_avg:.4f})"
        self.deque: typ.Deque[float] = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    def synchronize_between_processes(self):
        """all_reduce (count, total) across processes."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return
        backend_cuda = dist.get_backend() == "nccl"
        t = torch.tensor([self.count, self.total], dtype=torch.float64,
                         device="cuda" if backend_cuda else "cpu")
        dist.all_reduce(t)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self):
        return float(np.median(np.asarray(self.deque))) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(np.asarray(self.deque))) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "\t"):
        self.meters: typ.Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def log_every(self, iterable, print_freq: int, header: str = "",
                  total: typ.Optional[int] = None):
        i = 0
        if total is None:
            try:
                total = len(iterable)
            except TypeError:
                total = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        space_fmt = ":" + str(len(str(total))) + "d"
        log_msg = self.delimiter.join(
            [header, "[{0" + space_fmt + "}/{1}]", "eta: {eta}", "{meters}",
             "time: {time}", "data: {data}", "{memory}"])
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or i == total - 1:
                eta = iter_time.global_avg * (total - i)
                mem = _device_max_mem_mb()
                print(log_msg.format(
                    i, total, eta=str(datetime.timedelta(seconds=int(eta))),
                    meters=str(self), time=str(iter_time), data=str(data_time),
                    memory="" if mem is None else f"max mem: {mem:.0f}MB",
                ))
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        print("{} Total time: {} ({:.4f} s / it)".format(
            header, str(datetime.timedelta(seconds=int(total_time))),
            total_time / max(i, 1),
        ))
