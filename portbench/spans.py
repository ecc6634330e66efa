"""The program's spans and counters in a traced window, and the readers of
the per-layer metrics that read them.

The program marks its layer boundaries with ``torch.profiler``
``record_function`` ranges while a profiler session records (the names are
``slim_switch_moe_vit_tpu_torch.utils.profiling.SPANS``), and keeps host
counters (``profiling.counters()``). The trace has them on the device's
clock. :class:`Index` ties each device operation of the window to the
runtime or driver call that launched it (their ``correlation`` id), and
each call to the spans it belongs to. A call belongs to span S when

- it lies inside one of S's intervals, on any thread (the main thread
  waits in ``backward()`` while the autograd thread launches), or
- it lies inside a backward op (``autograd::engine::evaluate_function``)
  whose forward op lies inside S: the two carry the same ``Sequence
  number``, and the backward op names its forward thread.

So the backward's work is charged to the forward span that built it, with
no span in backward code.

The readers take a metric (its ``spans`` or ``counters``) and the traced
window (``readers.Window``). They read the trace's raw events
(``trace.events``) and the program's counters over the session
(``trace.counters``, the difference of ``profiling.counters()`` taken at
the session's start and stop), which ``devtrace`` does not keep yet. Each
returns None where it finds nothing to read: a program without the spans
or the counters, or a trace without its events. The harness reads none of
them until ``readers.READERS`` takes in :data:`READERS`; :data:`METRICS`
holds the metrics they serve, each as its metric file would give it.
"""
from __future__ import annotations

import bisect
import dataclasses
import typing as typ
import weakref

from .devtrace import DEVICE_CATEGORIES, gaps, merge

LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
BACKWARD = "autograd::engine::evaluate_function: "
SEQ, FWD_THREAD = "Sequence number", "Fwd thread id"


@dataclasses.dataclass
class Launch:
    """One runtime or driver call and the device operations it launched
    inside the window."""
    at: float                        # the call's start
    forward: typ.Optional[float]     # start of the forward op behind it
    ops: typ.List[typ.Tuple[float, float]]   # (start, duration) each


class Index:
    """The spans, launches and device operations of one trace's window
    ``[lo, hi]``, in microseconds of the trace's clock."""

    def __init__(self, events: typ.Iterable[dict], lo: float, hi: float):
        # name -> [(start, end)], every thread
        self.spans: typ.Dict[str, typ.List[typ.Tuple[float, float]]] = {}
        forward: typ.Dict[tuple, float] = {}   # (thread, seq) -> start
        backward: typ.Dict[typ.Any, list] = {}  # thread -> [(a, b, seq, ft)]
        calls: typ.Dict[typ.Any, tuple] = {}   # correlation -> (start, thread)
        ops: typ.Dict[typ.Any, list] = {}      # correlation -> [(start, dur)]
        self.device_us = 0.0                   # every device op in the window
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name, tid = e.get("cat"), e.get("name", ""), e.get("tid")
            ts, dur = float(e["ts"]), float(e.get("dur", 0))
            args = e.get("args") or {}
            if cat == "user_annotation":
                self.spans.setdefault(name, []).append((ts, ts + dur))
            elif cat == "cpu_op" and SEQ in args:
                if name.startswith(BACKWARD):
                    backward.setdefault(tid, []).append(
                        (ts, ts + dur, args[SEQ], args.get(FWD_THREAD)))
                elif not args.get(FWD_THREAD):
                    # ops that made no autograd node share the next one's
                    # number: the last to start is the node's own
                    key = (tid, args[SEQ])
                    forward[key] = max(ts, forward.get(key, ts))
            elif cat in LAUNCH_CATEGORIES and "correlation" in args:
                calls[args["correlation"]] = (ts, tid)
            elif (cat in DEVICE_CATEGORIES and ts >= lo
                  and ts + dur <= hi):
                self.device_us += dur
                if "correlation" in args:
                    ops.setdefault(args["correlation"], []).append((ts, dur))
        thread = _forward_threads(forward, backward)
        for rows in backward.values():
            rows.sort()
        starts = {t: [r[0] for r in rows] for t, rows in backward.items()}
        self.launches: typ.List[Launch] = []
        for corr, got in ops.items():
            if corr not in calls:
                continue
            at, tid = calls[corr]
            fwd = None
            rows = backward.get(tid)
            if rows:
                i = bisect.bisect_right(starts[tid], at) - 1
                if i >= 0 and rows[i][1] >= at:
                    _, _, seq, ft = rows[i]
                    fwd = forward.get((thread.get(ft), seq))
            self.launches.append(Launch(at, fwd, got))

    def covered(self, names: typ.Sequence[str]
                ) -> typ.List[typ.Tuple[float, float]]:
        """The union of the named spans' intervals, on every thread."""
        return merge(iv for n in names for iv in self.spans.get(n, ()))

    def launched_in(self, names: typ.Sequence[str]) -> typ.List[Launch]:
        """The launches that belong to any of the named spans."""
        cover = self.covered(names)
        starts = [a for a, _ in cover]

        def inside(t):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and cover[i][1] >= t

        return [ln for ln in self.launches if inside(ln.at)
                or (ln.forward is not None and inside(ln.forward))]

    def early_ops(self) -> int:
        """Device operations that start before the call that launched them
        (a trace whose host and device clocks disagree)."""
        return sum(ts < ln.at for ln in self.launches for ts, _ in ln.ops)


def _forward_threads(forward, backward) -> dict:
    """The host thread of each forward thread a backward op names (the
    profiler's own number, not the trace's thread): the thread whose
    forward ops hold most of its sequence numbers."""
    threads = {t for t, _ in forward}
    seqs: typ.Dict[typ.Any, list] = {}
    for rows in backward.values():
        for _, _, seq, ft in rows:
            seqs.setdefault(ft, []).append(seq)
    return {ft: max(threads, key=lambda t: sum((t, s) in forward for s in ss))
            for ft, ss in seqs.items() if threads}


_INDEXES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def index(trace) -> typ.Optional[Index]:
    """The trace's :class:`Index`, built once; None without its events."""
    if not getattr(trace, "events", None):
        return None
    if trace not in _INDEXES:
        _INDEXES[trace] = Index(trace.events, trace.lo, trace.hi)
    return _INDEXES[trace]


def _spans_of(metric: dict, w) -> typ.Optional[Index]:
    idx = index(w.trace)
    if (idx is None or w.units <= 0
            or not any(n in idx.spans for n in metric["spans"])):
        return None
    return idx


def span_device_ms(metric: dict, w) -> typ.Optional[float]:
    """Device ms a unit of the operations launched in the ``spans``
    listed, forward and backward."""
    idx = _spans_of(metric, w)
    if idx is None:
        return None
    us = sum(d for ln in idx.launched_in(metric["spans"]) for _, d in ln.ops)
    return 1e-3 * us / w.units


def span_launches(metric: dict, w) -> typ.Optional[float]:
    """Launches a unit in the ``spans`` listed: runtime and driver calls
    that put an operation on the device in the window."""
    idx = _spans_of(metric, w)
    if idx is None:
        return None
    return len(idx.launched_in(metric["spans"])) / w.units


def span_idle_ms(metric: dict, w) -> typ.Optional[float]:
    """The window's device-idle time that overlaps the union of the
    ``spans``' host intervals, in ms a unit."""
    idx = _spans_of(metric, w)
    if idx is None:
        return None
    cover = idx.covered(metric["spans"])
    us = sum(max(0.0, min(b, d) - max(a, c))
             for a, b in gaps(w.trace.busy, w.trace.lo, w.trace.hi)
             for c, d in cover)
    return 1e-3 * us / w.units


def counter_share(metric: dict, w) -> typ.Optional[float]:
    """``(c[a] - c[b]) / c[a]`` of the program's counters over the traced
    session, ``counters`` = [a, b]."""
    c = getattr(w.trace, "counters", None) or {}
    a, b = metric["counters"]
    if not c.get(a) or b not in c:
        return None
    return (c[a] - c[b]) / c[a]


READERS: typ.Dict[str, typ.Callable] = {
    "span_device_ms": span_device_ms, "span_launches": span_launches,
    "span_idle_ms": span_idle_ms, "counter_share": counter_share}

DISPATCH = ["moe.route", "moe.layout", "moe.gather", "moe.combine"]
TRAIN = ["moe_small_e8.train_b512", "moe_base_e32.train_b128"]
SERVE = ["moe_small_e8.serve_b128"]
TRACED = ("; read in the traced window, whose host work the profiler "
          "stretches: compare between commits only")


def _metric(layer, unit, better, source, moves, workloads, reader, why,
            **args) -> dict:
    return dict(layer=layer, unit=unit, better=better, source=source,
                moves=moves, workloads=workloads, reader=reader, why=why,
                **args)


METRICS: typ.Dict[str, dict] = {
    "moe_dispatch_ms.train": _metric(
        "MoE dispatch", "ms", "lower", "program_span",
        "train_images_per_s", TRAIN, "span_device_ms",
        "device ms a step launched in the spans moe.route, moe.layout, "
        "moe.gather, moe.combine, their backward by sequence number",
        spans=DISPATCH),
    "moe_dispatch_ms.serve": _metric(
        "MoE dispatch", "ms", "lower", "program_span",
        "serve_images_per_s", SERVE, "span_device_ms",
        "device ms a request launched in the spans moe.route, moe.layout, "
        "moe.gather, moe.combine", spans=DISPATCH),
    "expert_weight_cast_ms.train": _metric(
        "MoE dispatch", "ms", "lower", "program_span",
        "train_images_per_s", TRAIN, "span_device_ms",
        "device ms a step launched in the span moe.weights: the expert "
        "weights cast to bf16, and their gradients cast back",
        spans=["moe.weights"]),
    "launches.train": _metric(
        "train step", "launches", "lower", "program_span",
        "train_images_per_s", TRAIN, "span_launches",
        "runtime and driver calls a step that put work on the card, "
        "launched in the span train.step", spans=["train.step"]),
    "launches.serve": _metric(
        "serving", "launches", "lower", "program_span", "serve_p95_ms",
        SERVE, "span_launches",
        "runtime and driver calls a request that put work on the card, "
        "launched in the span serve.predict", spans=["serve.predict"]),
    "moe_dispatch_idle_ms.serve": _metric(
        "MoE dispatch", "ms", "lower", "program_span", "serve_p95_ms",
        SERVE, "span_idle_ms",
        "card-idle ms a request under the spans moe.route, moe.layout, "
        "moe.gather, moe.combine, moe.aux" + TRACED,
        spans=DISPATCH + ["moe.aux"]),
    "upload_idle_ms.serve": _metric(
        "serving", "ms", "lower", "program_span", "serve_p95_ms", SERVE,
        "span_idle_ms",
        "card-idle ms a request under the spans serve.pad, serve.upload"
        + TRACED, spans=["serve.pad", "serve.upload"]),
    "expert_padding_share.train": _metric(
        "MoE dispatch", "share", "lower", "program_counter",
        "train_images_per_s", TRAIN, "counter_share",
        "(moe.slots - moe.routed_rows) / moe.slots over the traced steps: "
        "the expert layout's padding rows", counters=["moe.slots",
                                                      "moe.routed_rows"]),
}
