"""Serving traffic: one closed-loop client calling the program's
``Predictor.predict`` with a request of ``batch`` uint8 images at a time,
as a batch scoring job does; the next request goes when the last one's
logits are on the host.

The program serves through its own objects: ``make_serve_fn(model)`` (the
normalisation on the card, the bf16 forward) under a ``Predictor`` with
the mix's buckets, built in memory without writing an artifact. Requests
draw their images from a pool of seeded blocks on the host. Set-up warms
the one bucket the mix uses.

The window: requests until ``--seconds`` have passed; the rate is all the
window's images over all its seconds, the tail the 95th percentile of all
its requests, each timed from the call to ``predict`` until its logits are
on the host. After the window the program serves a sample of the
window's requests, drawn from the seed, again with its routing recorded
(``capture.py``), and the reference serves them following that routing;
the check compares the window's answers with the reference's, and with the
answers served again. With ``--trace 1`` one profiler session then covers
``trace_requests`` more requests, each in a span of its own.
"""
from __future__ import annotations

import os
import statistics
import time
import typing as typ

import numpy as np
import torch

from .. import capture, check, devtrace, inputs, readers, weights
from ..counts import model as model_counts
from ..counts import shape as count_shape
from ..harness import Outcome, Run, note, peak_rates
from ..reference import model as ref_model
from .train import free, sync

END_TO_END = {"serve_images_per_s": "images/s", "serve_p95_ms": "ms",
              "setup_s": "s"}
REQUEST = "portbench.request"


def build(run: Run):
    """The program's ``Predictor`` over the seed's weights."""
    from slim_switch_moe_vit_tpu_torch.models import create_model
    from slim_switch_moe_vit_tpu_torch.serving.export import (Predictor,
                                                              make_serve_fn)

    cfg = run.cfg
    note(run, "program_imported")
    with torch.device("meta"):
        model = create_model(cfg["model"], num_classes=cfg["num_classes"],
                             img_size=cfg["img_size"],
                             dtype=getattr(torch, cfg["dtype"]))
    model = model.to_empty(device=run.device)
    note(run, "model_allocated")
    weights.load_into(model, cfg, run.seed)
    note(run, "weights")
    model.eval()
    manifest = {"model_name": cfg["model"], "img_size": cfg["img_size"],
                "num_classes": cfg["num_classes"],
                "compute_dtype": cfg["dtype"], "input_dtype": "uint8",
                "with_preprocess": True,
                "batch_sizes": list(run.traffic["buckets"])}
    return model, Predictor(make_serve_fn(model), manifest, run.device)


def blocks(run: Run) -> typ.List[np.ndarray]:
    B = run.traffic["batch"]
    return [inputs.serve_block(run.cfg, B, i, run.seed, run.device)
            for i in range(run.traffic["pool_blocks"])]


def sample(run: Run, n: int) -> typ.List[int]:
    """The requests the check compares, drawn from the seed."""
    g = weights.generator(run.seed, "serve_sample", "cpu")
    k = min(n, run.traffic["check_requests"])
    return sorted(torch.randperm(n, generator=g)[:k].tolist())


def reference_logits(run: Run, images: np.ndarray, mm=ref_model.matmul,
                     routes: typ.Optional[list] = None):
    """The reference's logits of ``images`` on the host, following
    ``routes`` (one whole-batch tensor per MoE block) where given: (logits,
    the share of ``routes``' pairs outside its own top-k, the routing
    taken); the share is inf where it cannot follow them."""
    ref_model.strict_f32()
    params = weights.make(run.cfg, run.seed, run.device)
    x = torch.from_numpy(images).to(run.device)
    try:
        out, flip, taken = ref_model.predict(
            params, x, run.cfg, mm, block=run.traffic["check_block"],
            routes=routes)
    except ref_model.RoutingMismatch:
        return torch.full((x.shape[0], run.cfg["num_classes"]),
                          float("nan")), float("inf"), None
    return out.cpu(), flip, taken


def served_again(run: Run, predictor, requests: typ.List[np.ndarray]):
    """The program's answers to ``requests`` and its routing of them, one
    whole-batch tensor per MoE block (None where its gate was called
    another number of times than there are blocks)."""
    depth = run.cfg["depth"]
    with capture.routes() as rec:
        answers = [predictor.predict(r) for r in requests]
    if len(rec) != depth * len(requests):
        return answers, None
    per_request = [rec[q * depth:(q + 1) * depth]
                   for q in range(len(requests))]
    return answers, ref_model.joined(per_request)


def p95(values: typ.Sequence[float]) -> float:
    """The 95th percentile, interpolated between the samples."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def run(run: Run) -> Outcome:
    tr = run.traffic
    B = tr["batch"]
    note(run, "imports")
    model, predictor = build(run)
    note(run, "model")
    pool = blocks(run)
    note(run, "requests")
    P = len(pool)
    for i in range(tr["warmup_requests"]):
        predictor.predict(pool[i % P])

    served: typ.List[np.ndarray] = []
    latency: typ.List[float] = []
    failed = 0
    sync(run.device)
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    t0 = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        try:
            logits = predictor.predict(pool[i % P])
        except RuntimeError:
            logits = None
        latency.append(time.perf_counter() - t)
        served.append(logits)
        i += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    t1 = time.perf_counter()
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    for logits in served:
        if (logits is None or logits.shape != (B, run.cfg["num_classes"])
                or not np.isfinite(logits).all()):
            failed += 1

    window = None
    if run.trace:
        session = devtrace.Session(os.path.join(
            run.out_dir, f"{run.workload}.{os.getpid()}.trace.json"))
        n = tr["trace_requests"]
        session.start()
        for j in range(n):
            with torch.profiler.record_function(REQUEST):
                predictor.predict(pool[(i + j) % P])
        traced = session.stop()
        os.remove(session.path)
        peaks = peak_rates(run.device)
        window = readers.Window(
            trace=traced, units=n,
            shape=count_shape(run.cfg, B, training=False),
            unit_flops=model_counts.serve_batch_flops(run.cfg, B),
            peak_flops=peaks["bf16_flops_per_s"],
            peak_bytes_per_s=peaks["hbm_bytes_per_s"],
            measured_units=i, measured_s=t1 - t0)
    picked = sample(run, i)
    again, routes = served_again(run, predictor, [pool[j % P] for j in picked])
    del model, predictor
    free(run.device)
    got = [served[j] for j in picked]
    if any(g is None for g in got):
        numbers = {}
    else:
        images = np.concatenate([pool[j % P] for j in picked])
        ref, flip, _ = reference_logits(run, images, routes=routes)
        if routes is None:
            flip = float("inf")
        numbers = check.serve_numbers(
            torch.from_numpy(np.concatenate(got)), ref, flip,
            torch.from_numpy(np.concatenate(again)))
    return Outcome(
        end_to_end={"serve_images_per_s": i * B / (t1 - t0),
                    "serve_p95_ms": 1e3 * p95(latency),
                    "setup_s": t0 - run.started},
        attempted=i, failed=failed, memory_peak_bytes=peak,
        numbers=numbers, window=window)


def readings(run: Run, sides: typ.Sequence[str]) -> typ.Dict[str, dict]:
    """The check's numbers of each side against the reference on the first
    ``check_requests`` blocks, for setting limits: ``program`` (its
    ``Predictor``), ``control`` (the reference in fp8 products in the
    program's place), ``altered`` (the program's answers with one image's
    logits replaced by its neighbour's, a planted fault)."""
    pool = blocks(run)[:run.traffic["check_requests"]]
    images = np.concatenate(pool)
    out: typ.Dict[str, tuple] = {}
    if "program" in sides or "altered" in sides:
        model, predictor = build(run)
        answers, routes = served_again(run, predictor, pool)
        del model, predictor
        free(run.device)
        served = torch.from_numpy(np.concatenate(answers))
        altered = served.clone()
        altered[0] = served[1]
        out["program"] = (served, routes)
        out["altered"] = (altered, routes)
    if "control" in sides:
        logits, _, routes = reference_logits(run, images,
                                             ref_model.matmul_fp8)
        out["control"] = (logits, routes)
    numbers = {}
    for k, (logits, routes) in out.items():
        if k in sides:
            ref, flip, _ = reference_logits(run, images, routes=routes)
            numbers[k] = check.serve_numbers(logits, ref, flip)
    return numbers
