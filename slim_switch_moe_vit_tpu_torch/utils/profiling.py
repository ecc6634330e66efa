"""Profiling helpers on ``torch.profiler``.

Port of ``slim_switch_moe_vit_tpu/utils/profiling.py``: :func:`trace`
records a region and :func:`summarize_trace` turns the newest trace into
per-kernel device-time totals, largest first.

The JAX package reads the Perfetto trace ``jax.profiler`` writes under
``<log_dir>/plugins/profile/<run>/*.trace.json.gz`` and keeps the TPU
process's ops, grouping XLA fusions by kind and shape. Here the trace is
``torch.profiler``'s Chrome trace, written as
``<log_dir>/<host>_<pid>.<ns>.pt.trace.json.gz``; its device events are
those of category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``, grouped by
their names (a CUDA kernel's name carries its template arguments).
"""
from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import socket
import time
import typing as typ

import torch

TRACE_SUFFIX = ".pt.trace.json.gz"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region (the host, and the card when CUDA is available)
    and write its trace under ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
        prof.export_chrome_trace(os.path.join(log_dir, name + TRACE_SUFFIX))


def summarize_trace(log_dir: str, top: int = 20,
                    steps: int = 1) -> typ.List[typ.Tuple[float, int, str]]:
    """Device-event durations of the newest trace under ``log_dir``, summed
    by name: ``[(ms per step, count, name)]``, largest first, at most
    ``top`` rows. Raises ``FileNotFoundError`` when there is no trace."""
    paths = glob.glob(os.path.join(log_dir, "*" + TRACE_SUFFIX))
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    with gzip.open(max(paths, key=os.path.getmtime), "rt") as f:
        events = json.load(f).get("traceEvents", [])
    tot: typ.Dict[str, float] = collections.defaultdict(float)
    cnt: typ.Counter = collections.Counter()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        tot[e["name"]] += float(e.get("dur", 0))
        cnt[e["name"]] += 1
    rows = sorted(((d / steps / 1e3, cnt[k], k) for k, d in tot.items()),
                  reverse=True)
    return rows[:top]
