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

The program's own instrumentation lives here too. :func:`span` marks a
layer boundary (the names are :data:`SPANS`): inside a profiler session it
is a ``torch.profiler.record_function`` range, on the trace's clock beside
the device's events; outside one it is a shared no-op, so it costs a flag
check. :func:`count` adds to a host counter, always on, and
:func:`counters` snapshots every counter the program keeps. Work in an
autograd backward carries no span: a trace ties each backward op to the
forward op that built it by sequence number.
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

SPANS = (
    # train step: engine.make_train_step's train_step, the whole call
    "train.step",
    # train step: host batch to the device, augment, mixup, BCE targets
    "train.upload",
    # train step: the teacher's forward, when distilling
    "train.teacher",
    # train step: the model's forward
    "train.forward",
    # train step: criterion, distillation, MoE metrics, balance term
    "train.loss",
    # train step: zero_grad, the backward, the gradients' data-group mean
    "train.backward",
    # train step: the optimizer and the EMA (or K7's fused form)
    "train.optimizer",
    # serving: Predictor.predict, the whole call
    "serve.predict",
    # serving: a chunk's bucket, zero padding and contiguous copy
    "serve.pad",
    # serving: a chunk's images to the device
    "serve.upload",
    # serving: the serving forward of a chunk
    "serve.forward",
    # serving: logits to the host, and the chunks joined
    "serve.download",
    # MoE dispatch: MoEMlp.forward, every dispatch mode
    "moe.forward",
    # MoE dispatch (fused): router logits and the top-k gate
    "moe.route",
    # MoE dispatch (fused): capacity and the padded expert layout
    "moe.layout",
    # MoE dispatch (fused): the expert weights cast for the FFN kernels
    "moe.weights",
    # MoE dispatch (fused): tokens gathered into the layout (none with K9)
    "moe.gather",
    # expert FFN (fused): the expert-FFN kernels
    "moe.ffn",
    # MoE dispatch (fused): slots combined into tokens, cast back
    "moe.combine",
    # MoE dispatch (fused): the balance loss and drop fraction
    "moe.aux",
)


_NO_SPAN = contextlib.nullcontext()   # the span outside a session
_COUNTS: typ.Dict[str, int] = {}


def span(name: str):
    """A context manager marking ``name`` (one of :data:`SPANS`): a
    ``record_function`` range while a profiler session records, else a
    shared no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def counters() -> typ.Dict[str, int]:
    """One snapshot of every counter the program keeps: those of
    :func:`count`, the kernel wrappers' launches as ``launch.<wrapper>``
    (``ops.launch_counts()``) and the attention routes as ``route.<name>``
    (``models.vit.ROUTE_COUNTS``)."""
    from .. import ops
    from ..models import vit

    out = dict(_COUNTS)
    out.update((f"launch.{k}", v) for k, v in ops.launch_counts().items())
    out.update((f"route.{k}", v) for k, v in vit.ROUTE_COUNTS.items())
    return out


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
