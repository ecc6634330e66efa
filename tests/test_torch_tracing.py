"""The port's spans and counters (``utils/profiling.py``) and the benchmark's
readers of them (``portbench/spans.py``), on the CPU.

A ViT of 2 blocks at D = 32 with 4 experts top-2 in each MLP (img 32,
patch 8: N = 17) trains a step and serves a request:

- without a profiler session ``span`` enters no ``record_function``, and
  a session changes no output, loss or gradient by a bit;
- inside one, each span of :data:`profiling.SPANS` appears as often as
  its layer runs and inside its parent (``moe.*`` inside ``moe.forward``
  inside ``train.forward`` or ``serve.forward``);
- the MoE counters grow by the layout's rows (Tp) and the routed rows (T k)
  a block, and ``counters()`` carries the launch and route counts.

The readers get a hand-written Chrome trace whose values are worked out by
hand: a forward op inside a span and its backward on another thread, the
kernels tied to their calls by ``correlation``, idle gaps. On the same trace
the benchmark's readers read the same with the program's spans as without.
"""
import json

import numpy as np
import pytest
import torch

from portbench import devtrace, harness, readers, spans
from slim_switch_moe_vit_tpu_torch import engine, losses, ops, optim
from slim_switch_moe_vit_tpu_torch.models import vit
from slim_switch_moe_vit_tpu_torch.models.moe import MoEMlp
from slim_switch_moe_vit_tpu_torch.models.vit import VisionTransformer
from slim_switch_moe_vit_tpu_torch.ops.moe import aligned_expert_layout
from slim_switch_moe_vit_tpu_torch.serving.export import (Predictor,
                                                          make_serve_fn)
from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
from slim_switch_moe_vit_tpu_torch.utils import profiling

CFG = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=32, depth=2,
           num_heads=2)
B, E, K, N = 2, 4, 2, 17
MOE = ["moe.route", "moe.layout", "moe.weights", "moe.gather", "moe.ffn",
       "moe.combine", "moe.aux"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model():
    def factory(idx, dim, ratio, drop, dt):
        return MoEMlp(dim, int(dim * ratio), num_experts=E, top_k=K)
    model = VisionTransformer(dtype=torch.float32, block_mlp_factory=factory,
                              **CFG)
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def _step():
    model = _model()
    opt_init, opt_update = optim.make_optimizer(weight_decay=0.05)
    state = create_train_state(model, device="cpu", opt_init=opt_init,
                               use_ema=True, seed=0)
    step = engine.make_train_step(
        model, opt_update, losses.make_base_criterion(False, 0.1, False),
        ema_decay=0.99)
    images = torch.from_numpy(np.random.RandomState(1).randn(
        B, 32, 32, 3).astype(np.float32))
    labels = torch.from_numpy(np.random.RandomState(2).randint(0, 10, B))
    return model, state, lambda: step(state, images, labels, 1e-3, 1e-3)


def _predictor():
    model = _model().eval()
    manifest = {"num_classes": 10, "batch_sizes": [4],
                "input_dtype": "uint8"}
    return Predictor(make_serve_fn(model), manifest, torch.device("cpu"))


IMAGES = np.random.RandomState(3).randint(0, 256, (6, 32, 32, 3), np.uint8)


def _profiled(fn, path):
    """``fn()`` inside a CPU profiler session: (its result, the trace's
    events)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return out, json.load(f)["traceEvents"]


def _intervals(events):
    idx = spans.Index(events, float("-inf"), float("inf"))
    return {k: v for k, v in idx.spans.items() if k in profiling.SPANS}


def _inside(iv, outer):
    return any(a <= iv[0] and iv[1] <= b for a, b in outer)


class _Counting:
    entered = 0

    def __init__(self, real):
        self.real = real

    def __call__(self, name, *args):
        _Counting.entered += 1
        return self.real(name, *args)


def test_without_a_session_no_span_is_entered(monkeypatch):
    monkeypatch.setattr(_Counting, "entered", 0)
    monkeypatch.setattr(torch.profiler, "record_function",
                        _Counting(torch.profiler.record_function))
    assert not torch.autograd._profiler_enabled()
    _, _, run = _step()
    run()
    _predictor().predict(IMAGES)
    assert _Counting.entered == 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _predictor().predict(IMAGES)
    assert _Counting.entered > 0


def test_a_session_changes_no_bit(tmp_path):
    got = []
    for traced in (False, True):
        model, state, run = _step()
        if traced:
            (_, metrics), _ = _profiled(run, tmp_path / "t.json")
        else:
            _, metrics = run()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        served = (_profiled(lambda: _predictor().predict(IMAGES),
                            tmp_path / "s.json")[0] if traced
                  else _predictor().predict(IMAGES))
        got.append((metrics["loss"], grads, params, served))
    (l0, g0, p0, s0), (l1, g1, p1, s1) = got
    assert torch.equal(l0, l1)
    assert np.array_equal(s0, s1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
        assert torch.equal(p0[n], p1[n]), n


def test_a_train_step_carries_its_spans_nested(tmp_path):
    _, _, run = _step()
    run()
    _, events = _profiled(run, tmp_path / "t.json")
    iv = _intervals(events)
    once = ["train.step", "train.upload", "train.forward", "train.loss",
            "train.backward", "train.optimizer"]
    assert {k: len(v) for k, v in iv.items()} == {
        **{k: 1 for k in once}, **{k: CFG["depth"] for k in
                                   ["moe.forward"] + MOE}}
    for k in once[1:]:
        assert _inside(iv[k][0], iv["train.step"]), k
    for a in iv["moe.forward"]:
        assert _inside(a, iv["train.forward"])
    for k in MOE:
        assert all(_inside(a, iv["moe.forward"]) for a in iv[k]), k


def test_a_request_carries_its_spans_nested(tmp_path):
    predictor = _predictor()
    _, events = _profiled(lambda: predictor.predict(IMAGES),
                          tmp_path / "s.json")
    iv = _intervals(events)
    chunks = 2    # 4 images, then 2 padded to the bucket of 4
    assert {k: len(v) for k, v in iv.items()} == {
        "serve.predict": 1, "serve.pad": chunks, "serve.upload": chunks,
        "serve.forward": chunks, "serve.download": chunks + 1,
        **{k: chunks * CFG["depth"] for k in ["moe.forward"] + MOE}}
    for k in ("serve.pad", "serve.upload", "serve.forward",
              "serve.download"):
        assert all(_inside(a, iv["serve.predict"]) for a in iv[k]), k
    for a in iv["moe.forward"]:
        assert _inside(a, iv["serve.forward"])
    for k in MOE:
        assert all(_inside(a, iv["moe.forward"]) for a in iv[k]), k


def test_the_counters_count_the_layout_and_carry_launches_and_routes():
    _, _, run = _step()
    before = profiling.counters()
    run()
    after = profiling.counters()
    T = B * N
    gather_idx = aligned_expert_layout(
        torch.zeros(T, K, dtype=torch.long), E)[0]
    delta = {k: after[k] - before.get(k, 0) for k in after}
    assert delta["moe.slots"] == CFG["depth"] * gather_idx.shape[0]
    assert delta["moe.routed_rows"] == CFG["depth"] * T * K
    assert {k: v for k, v in after.items() if k.startswith("launch.")} == {
        f"launch.{k}": v for k, v in ops.launch_counts().items()}
    assert {k: v for k, v in after.items() if k.startswith("route.")} == {
        f"route.{k}": v for k, v in vit.ROUTE_COUNTS.items()}
    assert any(k.startswith("launch.") for k in after)
    assert any(k.startswith("route.") for k in after)


# -- the readers on a hand-written trace (microseconds) -----------------------

def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


PROGRAM_SPANS = [
    _x("user_annotation", "train.step", 10, 890),
    _x("user_annotation", "train.forward", 20, 280),
    _x("user_annotation", "moe.forward", 30, 170),
    _x("user_annotation", "moe.route", 40, 40),
    _x("user_annotation", "moe.weights", 90, 30),
    _x("user_annotation", "train.backward", 400, 400),
]
SEQ, FWD = "Sequence number", "Fwd thread id"
BWD = "autograd::engine::evaluate_function: "
EVENTS = [
    _x("user_annotation", devtrace.WINDOW, 0, 1000),
    *PROGRAM_SPANS,
    # seq 7: a view that made no node, then the mm that made it
    _x("cpu_op", "aten::view", 35, 2, **{SEQ: 7, FWD: 0}),
    _x("cpu_op", "aten::mm", 50, 10, **{SEQ: 7, FWD: 0}),
    _x("cpu_op", "aten::_to_copy", 95, 10, **{SEQ: 8, FWD: 0}),
    _x("cpu_op", BWD + "MmBackward0", 500, 60, tid=2, **{SEQ: 7, FWD: 1}),
    _x("cpu_op", BWD + "ToCopyBackward0", 600, 50, tid=2,
       **{SEQ: 8, FWD: 1}),
    _x("cuda_runtime", "cudaLaunchKernel", 55, 3, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 100, 3, correlation=2),
    _x("cuda_runtime", "cudaMemcpyAsync", 250, 3, correlation=3),
    _x("cuda_driver", "cuLaunchKernel", 510, 3, tid=2, correlation=4),
    _x("cuda_runtime", "cudaLaunchKernelExC", 610, 3, tid=2, correlation=5),
    _x("cuda_runtime", "cudaLaunchKernel", 950, 3, correlation=6),
    _x("cuda_runtime", "cudaLaunchKernel", 970, 3, correlation=7),
    _x("kernel", "router_gemm", 60, 20, tid=7, correlation=1),
    _x("kernel", "cast_bf16", 105, 30, tid=7, correlation=2),
    _x("gpu_memcpy", "Memcpy HtoD", 260, 40, tid=7, correlation=3),
    _x("kernel", "router_gemm_bwd", 520, 50, tid=7, correlation=4),
    _x("kernel", "cast_f32", 620, 10, tid=7, correlation=5),
    _x("kernel", "after_step", 960, 5, tid=7, correlation=6),
    _x("kernel", "early", 965, 5, tid=7, correlation=7),   # before its call
]
UNITS = 2
# one row of width 1: K3's count is 4 FLOPs and 16 bytes
SHAPE = dict(B=1, N=1, D=1, H=1, E=1, k=1, depth=1, act_bytes=2,
             training=True)


def _window(events, counters=None):
    trace = devtrace.Trace(events)
    trace.events = events
    trace.counters = counters or {}
    return readers.Window(trace=trace, units=UNITS, shape=SHAPE,
                          unit_flops=1e9, peak_flops=1e12,
                          peak_bytes_per_s=1e9, measured_units=4,
                          measured_s=0.004)


def _read(reader, w, **args):
    return spans.READERS[reader](args, w)


def test_the_span_readers_read_the_hand_written_trace():
    w = _window(EVENTS)
    # the route's forward kernel and, by sequence number, its backward's
    assert _read("span_device_ms", w, spans=["moe.route"]) == pytest.approx(
        (20 + 50) / 1e3 / UNITS)
    assert _read("span_device_ms", w, spans=["moe.weights"]) == \
        pytest.approx((30 + 10) / 1e3 / UNITS)
    assert _read("span_device_ms", w, spans=["moe.route", "moe.forward"]) \
        == pytest.approx((20 + 30 + 50 + 10) / 1e3 / UNITS)
    assert _read("span_device_ms", w, spans=["train.step"]) == \
        pytest.approx((20 + 30 + 40 + 50 + 10) / 1e3 / UNITS)
    # the backward's calls lie in train.backward's interval, on thread 2
    assert _read("span_launches", w, spans=["train.backward"]) == 2 / UNITS
    assert _read("span_launches", w, spans=["train.step"]) == 5 / UNITS
    assert _read("span_launches", w, spans=["moe.forward"]) == 4 / UNITS
    # idle: route [40, 80] busy [60, 80]; backward [400, 800] busy 60 us
    assert _read("span_idle_ms", w, spans=["moe.route"]) == pytest.approx(
        20 / 1e3 / UNITS)
    assert _read("span_idle_ms", w, spans=["train.backward"]) == \
        pytest.approx((400 - 50 - 10) / 1e3 / UNITS)
    assert _read("span_idle_ms", w, spans=["moe.route", "moe.forward"]) == \
        pytest.approx((170 - 20 - 30) / 1e3 / UNITS)
    idx = spans.index(w.trace)
    assert idx.early_ops() == 1
    assert idx.device_us == 20 + 30 + 40 + 50 + 10 + 5 + 5
    for reader in ("span_device_ms", "span_launches", "span_idle_ms"):
        assert _read(reader, w, spans=["serve.predict"]) is None
        assert _read(reader, _window([]), spans=["train.step"]) is None


def test_the_counter_reader_reads_the_session_s_counters():
    w = _window(EVENTS, {"moe.slots": 1280, "moe.routed_rows": 1000})
    c = ["moe.slots", "moe.routed_rows"]
    assert _read("counter_share", w, counters=c) == pytest.approx(
        280 / 1280)
    assert _read("counter_share", _window(EVENTS), counters=c) is None
    assert _read("counter_share", _window(EVENTS, {"moe.slots": 0,
                                                   "moe.routed_rows": 0}),
                 counters=c) is None


def test_the_benchmark_s_readers_read_the_same_beside_the_spans():
    bare = [e for e in EVENTS if e not in PROGRAM_SPANS]
    with_spans, without = _window(EVENTS), _window(bare)
    busy = (20 + 30 + 40 + 50 + 10 + 10) / 1e6     # [960, 970] merged
    expect = {"device_ms": 1e3 * 50e-6 / UNITS,
              "roofline": 100.0 * UNITS * (16 / 1e9) / 50e-6,
              "idle_share": 1.0 - (busy / UNITS) / (0.004 / 4),
              "host_ms": 1e3 * (0.004 / 4 - busy / UNITS),
              "mfu": 100.0 * 4 * 1e9 / (0.004 * 1e12)}
    for w in (with_spans, without):
        for reader, value in expect.items():
            got = readers.READERS[reader](
                {"patterns": ["router_gemm_bwd"], "count": "expert_ffn_fwd"},
                w)
            assert got == pytest.approx(value), reader
        assert w.trace.busy_s == pytest.approx(busy)
    assert with_spans.trace.top_ops() == without.trace.top_ops()


def test_every_span_a_metric_reads_is_one_the_program_emits():
    named = [s for m in spans.METRICS.values() for s in m.get("spans", ())]
    for name in harness.names("metrics"):
        named += harness.load("metrics", name).get("spans", [])
    assert named and set(named) <= set(profiling.SPANS)
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    for m in spans.METRICS.values():
        assert m["reader"] in spans.READERS
        assert 1 <= len(m["why"]) <= 200
