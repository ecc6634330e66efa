"""One ``torch.profiler`` session over a traced window, and its reading.

The session records the host and the card (CUPTI) and writes its Chrome
trace inside the checkout. The window is the benchmark's own
``record_function`` span (:data:`WINDOW`), opened after a synchronise and
closed after one, so every device operation launched in it also ends in it.
Device operations are the trace's events of category ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` (the reading of the program's
``utils/profiling.py``, kept here as the benchmark's own copy).
"""
from __future__ import annotations

import bisect
import gzip
import json
import os
import re
import typing as typ

WINDOW = "portbench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


class Session:
    """The run's one profiler session: :meth:`start` opens the window after
    a synchronise, :meth:`stop` closes it after one and writes the trace to
    ``path``. Spans inside the window are the benchmark's
    ``torch.profiler.record_function`` ranges."""

    def __init__(self, path: str):
        self.path = path
        self._prof = self._span = None

    def start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        torch.cuda.synchronize()
        self._span = torch.profiler.record_function(WINDOW)
        self._span.__enter__()

    def stop(self) -> "Trace":
        import torch

        torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        self._prof = self._span = None
        return Trace.load(self.path)


class Trace:
    """The events of one trace, in microseconds of the trace's clock."""

    def __init__(self, events: typ.Iterable[dict]):
        self.device: typ.List[typ.Tuple[float, float, str]] = []
        self.host: typ.List[typ.Tuple[float, float, str]] = []
        self.spans: typ.Dict[str, typ.List[typ.Tuple[float, float]]] = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0))
            if cat in DEVICE_CATEGORIES:
                self.device.append((ts, dur, e.get("name", "")))
            elif cat in HOST_CATEGORIES:
                self.host.append((ts, dur, e.get("name", "")))
                if cat == "user_annotation":
                    self.spans.setdefault(e["name"], []).append((ts, dur))
        self.device.sort()
        self.host.sort()
        self._host_starts = [h[0] for h in self.host]
        win = self.spans.get(WINDOW)
        if win:
            self.lo, d = win[0]
            self.hi = self.lo + d
        elif self.device:
            self.lo = self.device[0][0]
            self.hi = max(t + d for t, d, _ in self.device)
        else:
            self.lo = self.hi = 0.0
        self.in_window = [ev for ev in self.device
                          if ev[0] >= self.lo and ev[0] + ev[1] <= self.hi]
        self.busy = merge((t, t + d) for t, d, _ in self.in_window)

    @classmethod
    def load(cls, path: str) -> "Trace":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            return cls(json.load(f).get("traceEvents", []))

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    @property
    def busy_s(self) -> float:
        return busy_between(self.busy, self.lo, self.hi) * 1e-6

    def matching_s(self, patterns: typ.Sequence[str]) -> float:
        """Device seconds in the window of operations whose name contains
        one of ``patterns``."""
        rx = re.compile("|".join(re.escape(p) for p in patterns))
        return sum(d for _, d, n in self.in_window if rx.search(n)) * 1e-6

    def top_ops(self, n: int = TOP) -> typ.List[list]:
        """The device operations that took most time in the window, by
        short name: ``[[name, seconds], ...]``."""
        tot: typ.Dict[str, float] = {}
        for _, d, name in self.in_window:
            k = short_name(name)
            tot[k] = tot.get(k, 0.0) + d
        rows = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-6] for k, v in rows]

    def host_at(self, t: float) -> str:
        """The innermost host operation running at ``t``, or ``idle``."""
        i = bisect.bisect_right(self._host_starts, t)
        best = None
        for j in range(i - 1, max(-1, i - 4000), -1):
            ts, d, name = self.host[j]
            if ts + d >= t and (best is None or d < best[0]):
                best = (d, name)
        return best[1] if best else "idle"

    def idle_gaps(self, n: int = TOP) -> typ.List[list]:
        """The window's idle time on the device, summed by the host
        operation running in each gap: ``[[name, seconds], ...]``."""
        tot: typ.Dict[str, float] = {}
        for a, b in gaps(self.busy, self.lo, self.hi):
            k = short_name(self.host_at((a + b) / 2))
            tot[k] = tot.get(k, 0.0) + (b - a)
        rows = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-6] for k, v in rows]


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = name.find("(")
    if cut > 0:
        name = name[:cut]
    return name[:width].strip()


def merge(intervals: typ.Iterable[typ.Tuple[float, float]]
          ) -> typ.List[typ.Tuple[float, float]]:
    out: typ.List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_between(merged, lo: float, hi: float) -> float:
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def gaps(merged, lo: float, hi: float) -> typ.List[typ.Tuple[float, float]]:
    out, t = [], lo
    for a, b in merged:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]
