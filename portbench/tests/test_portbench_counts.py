"""The work counts behind MFU and the rooflines, and the readers' handling
of a trace with nothing to read."""
from __future__ import annotations

import pytest
from portbench_tiny import ROOT  # noqa: F401  (puts the checkout on the path)

from portbench import harness, readers
from portbench.counts import FUNCTIONS, forward_flops_per_image, shape
from portbench.counts import model as model_counts
from portbench.devtrace import WINDOW, Trace

SMALL = harness.load("configs", "moe_small_patch16_224_expert8")
BASE = harness.load("configs", "moe_base_patch16_224_expert32")


def test_forward_flops_per_image():
    assert forward_flops_per_image(SMALL) / 1e9 == pytest.approx(14.79,
                                                                 abs=0.005)
    assert forward_flops_per_image(BASE) / 1e9 == pytest.approx(57.55,
                                                                abs=0.005)


def test_step_and_request_flops():
    assert model_counts.train_step_flops(SMALL, 256) / 1e12 == pytest.approx(
        11.36, abs=0.005)
    assert model_counts.serve_batch_flops(SMALL, 128) / 1e12 == pytest.approx(
        1.893, abs=0.0005)
    assert model_counts.train_step_flops(BASE, 128) / 1e12 == pytest.approx(
        22.1, abs=0.05)


@pytest.mark.parametrize("cfg", [SMALL, BASE], ids=["small", "base"])
def test_expert_ffn_counts_routed_rows(cfg):
    s = shape(cfg, 64, training=True)
    rows = 64 * 197 * cfg["top_k"]
    D, H = cfg["embed_dim"], cfg["hidden"]
    fwd, _ = FUNCTIONS["expert_ffn_fwd"](s)
    bwd, _ = FUNCTIONS["expert_ffn_bwd"](s)
    assert fwd == 12 * 4 * rows * D * H
    assert bwd == 12 * 8 * rows * D * H


def test_attention_counts_flops_not_macs():
    s = shape(SMALL, 2, training=True)
    fwd, _ = FUNCTIONS["attention_fwd"](s)
    bwd, _ = FUNCTIONS["attention_bwd"](s)
    assert fwd == 12 * 2 * 2 * (2 * 197 * 197 * 384)  # QK^T and PV, 2/MAC
    assert bwd == 2 * fwd


def test_layernorm_is_bound_by_its_bytes():
    s = shape(SMALL, 256, training=True)
    flops, nbytes = FUNCTIONS["layernorm"](s)
    assert nbytes / 3.35e12 > flops / 989e12


def _trace(kernels, window=(0.0, 1000.0)):
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW,
               "ts": window[0], "dur": window[1] - window[0]}]
    events += [{"ph": "X", "cat": "kernel", "name": n, "ts": t, "dur": d}
               for n, t, d in kernels]
    return Trace(events)


def _window(trace, units=1, measured_s=0.0):
    return readers.Window(trace=trace, units=units,
                          shape=shape(SMALL, 256, training=True),
                          unit_flops=model_counts.train_step_flops(SMALL, 256),
                          peak_flops=989e12, peak_bytes_per_s=3.35e12,
                          measured_units=units if measured_s else 0,
                          measured_s=measured_s)


def test_a_metric_with_no_matching_kernel_is_absent():
    w = _window(_trace([("void some_other_kernel<float>(int)", 10.0, 5.0)]))
    for name in ("expert_ffn_fwd_roofline.train", "optimizer_ms.train"):
        assert readers.read(harness.load("metrics", name), w) is None
    empty = _window(Trace([]))
    for name in ("mfu.train", "idle_share.train", "host_ms.serve"):
        assert readers.read(harness.load("metrics", name), empty) is None
    no_kernels = _window(Trace([]), measured_s=1.0)
    for name in ("idle_share.train", "host_ms.serve"):
        assert readers.read(harness.load("metrics", name), no_kernels) is None


def test_roofline_is_least_time_over_device_time():
    m = harness.load("metrics", "expert_ffn_fwd_roofline.train")
    flops, nbytes = FUNCTIONS["expert_ffn_fwd"](shape(SMALL, 256, True))
    least_us = max(flops / 989e12, nbytes / 3.35e12) * 1e6
    w = _window(_trace([("void expert_ffn_fwd_kernel<384>(x)", 0.0,
                         least_us * 2)], window=(0.0, least_us * 4)))
    assert readers.read(m, w) == pytest.approx(50.0)


def test_busy_idle_and_gaps_named_by_the_host():
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW,
               "ts": 0.0, "dur": 100.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
               "ts": 40.0, "dur": 30.0}]
    events += [{"ph": "X", "cat": "kernel", "name": "k", "ts": t, "dur": d}
               for t, d in ((0.0, 20.0), (10.0, 20.0), (80.0, 20.0))]
    tr = Trace(events)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(50e-6)
    gaps = dict((k, v) for k, v in tr.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(50e-6)
    # the measured window took 80 us a unit; the traced one, slowed by the
    # profiler, 100 us with 50 us busy
    w = _window(tr, measured_s=80e-6)
    assert readers.idle_share({}, w) == pytest.approx(1 - 50 / 80)
    assert readers.host_ms({}, w) == pytest.approx(30e-3)
    assert readers.mfu({}, w) == pytest.approx(
        100 * model_counts.train_step_flops(SMALL, 256) / (80e-6 * 989e12))
