"""The readers of the per-layer metrics.

A metric file (``metrics/<name>.json``) names its reader (``"reader"``)
and the reader's arguments. Each reader takes the metric and the traced
window's facts (:class:`Window`) and returns a number, or None where it
finds nothing to read: the harness then leaves the metric out of the line.
A share of a roofline or of the peak is never made 0 for want of a
reading.
"""
from __future__ import annotations

import dataclasses
import typing as typ

from .counts import FUNCTIONS
from .devtrace import Trace


@dataclasses.dataclass
class Window:
    trace: Trace
    units: int            # steps or served batches in the traced window
    shape: dict           # counts.shape of the cell
    unit_flops: float     # the model's FLOPs of one unit
    peak_flops: float
    peak_bytes_per_s: float
    measured_units: int = 0   # units in the measured (untraced) window
    measured_s: float = 0.0   # its seconds, host clock


def roofline(metric: dict, w: Window) -> typ.Optional[float]:
    """The least time of the counted work over the device time of the
    kernels matching ``patterns``, in %."""
    t = w.trace.matching_s(metric["patterns"])
    if t <= 0.0 or w.units <= 0:
        return None
    flops, nbytes = FUNCTIONS[metric["count"]](w.shape)
    least = w.units * max(flops / w.peak_flops, nbytes / w.peak_bytes_per_s)
    return 100.0 * least / t


def device_ms(metric: dict, w: Window) -> typ.Optional[float]:
    """Device ms per unit of the kernels matching ``patterns``."""
    t = w.trace.matching_s(metric["patterns"])
    if t <= 0.0 or w.units <= 0:
        return None
    return 1e3 * t / w.units


def mfu(metric: dict, w: Window) -> typ.Optional[float]:
    """The model's FLOPs of the measured window over its seconds at the
    card's peak, in %: the window the end-to-end rate is taken over, which
    the profiler does not slow."""
    if w.measured_units <= 0 or w.measured_s <= 0.0:
        return None
    return (100.0 * w.measured_units * w.unit_flops
            / (w.measured_s * w.peak_flops))


def idle_share(metric: dict, w: Window) -> typ.Optional[float]:
    """The share of a unit's time in which no operation ran on the device:
    1 - (device busy seconds per unit, from the trace) / (seconds per unit
    of the measured window). The traced window's own share, which the
    result line's ``busy_s`` and ``window_s`` give, is taken with the
    profiler's host work in it."""
    per_unit = _measured_per_unit(w)
    if per_unit is None or not w.trace.in_window or w.units <= 0:
        return None
    return 1.0 - (w.trace.busy_s / w.units) / per_unit


def host_ms(metric: dict, w: Window) -> typ.Optional[float]:
    """A unit's wall time in the measured window less the device's busy
    time per unit in the trace, in ms: the host's share of a request
    (upload, padding, launch pace, download) that the device waits for."""
    per_unit = _measured_per_unit(w)
    if per_unit is None or not w.trace.in_window or w.units <= 0:
        return None
    return 1e3 * (per_unit - w.trace.busy_s / w.units)


def _measured_per_unit(w: Window) -> typ.Optional[float]:
    if w.measured_units <= 0 or w.measured_s <= 0.0:
        return None
    return w.measured_s / w.measured_units


READERS: typ.Dict[str, typ.Callable] = {
    "roofline": roofline, "device_ms": device_ms, "mfu": mfu,
    "idle_share": idle_share, "host_ms": host_ms}


def read(metric: dict, w: Window) -> typ.Optional[float]:
    return READERS[metric["reader"]](metric, w)
