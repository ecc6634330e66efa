#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure propagates and the script exits non-zero):

1. Print the card (``nvidia-smi`` name and power limit) and build the CUDA
   kernels from ``slim_switch_moe_vit_tpu_torch/csrc``.
2. Kernels: at the flagship serving shapes (B = 32 and 128, N = 197,
   D = 384, bf16) each kernel (LayerNorm K1a/K1b/K2a in Triton, MHA K5 and
   expert FFN K3 in CUDA C++) is held against its plain PyTorch version on
   the card, within ``ATOL``/``RTOL``, and both are timed (median of
   CUDA-event timings).
3. Serving: ``moe_small_patch16_224_expert8`` at full width (ViT-S/16, 12
   blocks, 8 experts top-2), bf16, seeded random weights, exported through
   the export CLI with buckets 1, 8 and 32, loaded, and served over HTTP on
   127.0.0.1. Requests of 1, 5 and 40 images must come back finite, of the
   right shape and equal to the Predictor's own output, and the kernels'
   launch counters must rise by 25 LN (1 no-add, 23 add, 1 slim), 12 MHA
   and 12 expert-FFN launches per forward.
4. Cross-check: the same weights and 8 images through the port's plain
   path on the CPU in f32, against the card's bf16 logits (``XCHECK_*``).
5. Speed: serving images/s at bucket 32, p50 latency at batch 1, device
   time per forward at B = 32 and 128, and the device-time breakdown of one
   B = 128 forward by kernel.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

MODEL = "moe_small_patch16_224_expert8"
N_TOK, DIM, HEADS, EXPERTS, HIDDEN = 197, 384, 6, 8, 1536
BUCKETS = (1, 8, 32)
REQUESTS = (1, 5, 40)              # a padded bucket, a padded tail, chunking
PER_FORWARD = {"fused_ln": 1, "fused_add_ln": 23, "fused_sum_ln": 1,
               "fused_mha": 12, "fused_expert_ffn": 12}
# kernel vs plain version on the card, bf16 outputs: |d| <= atol + rtol*|ref|
# elementwise; 1.6e-2 is two bf16 ulps at 1.0 (the two sides round once
# each, with f32 sums taken in different orders)
ATOL = RTOL = 1.6e-2
# card bf16 logits vs CPU f32 logits: max |d| within 5% of max |ref| (a
# CPU-only bf16 run of this model differs by 1.4%), cosine >= 0.999 per
# image, and the same top-1 wherever the f32 top-1 margin exceeds twice
# the largest |d|
XCHECK_REL, XCHECK_COS = 5e-2, 0.999
KERNELS = [  # name, route, source, TPU kernel it replaces
    ("fused_ln", "triton", "slim_switch_moe_vit_tpu_torch/ops/_fused_ln_triton.py",
     "slim_switch_moe_vit_tpu/ops/fused_ln.py:123"),
    ("fused_add_ln", "triton", "slim_switch_moe_vit_tpu_torch/ops/_fused_ln_triton.py",
     "slim_switch_moe_vit_tpu/ops/fused_ln.py:117"),
    ("fused_sum_ln", "triton", "slim_switch_moe_vit_tpu_torch/ops/_fused_ln_triton.py",
     "slim_switch_moe_vit_tpu/ops/fused_ln.py:268"),
    ("fused_mha", "cuda", "slim_switch_moe_vit_tpu_torch/csrc/mha_fwd.cu",
     "slim_switch_moe_vit_tpu/ops/attention.py:168"),
    ("fused_expert_ffn", "cuda",
     "slim_switch_moe_vit_tpu_torch/csrc/expert_ffn_fwd.cu",
     "slim_switch_moe_vit_tpu/ops/fused_ffn.py:166"),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_cases(B: int, gen):
    """{name: (kernel call, plain call)} on random inputs at batch B."""
    import torch

    from slim_switch_moe_vit_tpu_torch.ops import attention, fused_ffn
    from slim_switch_moe_vit_tpu_torch.ops import fused_ln as ln
    from slim_switch_moe_vit_tpu_torch.ops import moe

    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * std).to("cuda", dtype)

    x, r = rnd(B, N_TOK, DIM), rnd(B, N_TOK, DIM)
    g = rnd(DIM, std=0.1, dtype=torch.float32) + 1.0
    b = rnd(DIM, std=0.1, dtype=torch.float32)
    qkv = rnd(B, N_TOK, 3 * DIM)
    scale = (DIM // HEADS) ** -0.5
    # the expert FFN on a real layout: routed tokens, counting-sort slots
    tokens = rnd(B * N_TOK, DIM)
    router_w = rnd(DIM, EXPERTS, std=DIM ** -0.5, dtype=torch.float32)
    _, eidx = moe.naive_topk_gate(tokens.float() @ router_w, 2)
    gather_idx, _, e_of_tile = moe.aligned_expert_layout(eidx, EXPERTS)
    xs = moe.dispatch_gather(tokens, gather_idx)
    ffn = (xs, rnd(EXPERTS, DIM, HIDDEN, std=DIM ** -0.5),
           rnd(EXPERTS, HIDDEN, std=0.1, dtype=torch.float32),
           rnd(EXPERTS, HIDDEN, DIM, std=HIDDEN ** -0.5),
           rnd(EXPERTS, DIM, std=0.1, dtype=torch.float32), e_of_tile)
    return {
        "fused_ln": (lambda: ln.fused_ln(x, g, b),
                     lambda: ln.reference_add_ln(x, None, g, b)[1]),
        "fused_add_ln": (lambda: ln.fused_add_ln(x, r, g, b),
                         lambda: ln.reference_add_ln(x, r, g, b)),
        "fused_sum_ln": (lambda: ln.fused_sum_ln(x, r, g, b),
                         lambda: ln.reference_add_ln(x, r, g, b)[1]),
        "fused_mha": (lambda: attention.fused_mha(qkv, HEADS, scale),
                      lambda: attention.fused_mha_reference(qkv, HEADS, scale)),
        "fused_expert_ffn": (lambda: fused_ffn.fused_expert_ffn(*ffn),
                             lambda: fused_ffn.fused_expert_ffn_reference(*ffn)),
    }


def compare(name: str, got, want) -> tuple:
    """(max |got - want|, that over max |want|) across every output; raises
    beyond ATOL/RTOL."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst, rel = 0.0, 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{name}: shape {tuple(a.shape)} vs "
                                 f"{tuple(b.shape)} or non-finite output")
        d = (a - b).abs()
        worst = max(worst, d.max().item())
        rel = max(rel, d.max().item() / b.abs().max().item())
        if not (d <= ATOL + RTOL * b.abs()).all():
            raise AssertionError(f"{name}: max |d| {d.max().item():.3e} beyond "
                                 f"atol {ATOL} + rtol {RTOL} * |ref|")
    return worst, rel


def kernel_phase(results: dict) -> None:
    import torch

    gen = torch.Generator().manual_seed(0)
    for B in (32, 128):
        for name, (kernel, plain) in kernel_cases(B, gen).items():
            t0 = time.perf_counter()
            got = kernel()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            err, rel = compare(name, got, plain())
            ms, plain_ms = median_ms(kernel), median_ms(plain, reps=10)
            res = results.setdefault(name, {"max_abs_err": 0.0})
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res.update({"ms" if B == 32 else "ms_b128": ms,
                        "plain_ms" if B == 32 else "plain_ms_b128": plain_ms})
            log(f"kernel {name:17s} B={B:3d}: max|d| {err:.3e}, relative to "
                f"max|ref| {rel:.2e} (elementwise atol/rtol {ATOL:g}) kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, first call "
                f"{first_s:.2f} s")


def forwards_for(n: int) -> int:
    """Forwards the Predictor runs for n images (the bucket rule)."""
    count = 0
    while n > 0:
        fits = [b for b in BUCKETS if b >= n]
        n -= min(n, min(fits) if fits else max(BUCKETS))
        count += 1
    return count


def post(port: int, images: np.ndarray) -> np.ndarray:
    body = json.dumps({"instances": images.tolist()}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict",
                                 data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return np.asarray(json.loads(resp.read())["predictions"], np.float32)


def serving_phase(artifact: str, rs) -> tuple:
    from slim_switch_moe_vit_tpu_torch import ops
    from slim_switch_moe_vit_tpu_torch.serving import export
    from slim_switch_moe_vit_tpu_torch.serving.export import load_predictor
    from slim_switch_moe_vit_tpu_torch.serving.server import make_server

    t0 = time.perf_counter()
    manifest = export.main(["--model", MODEL, "--output", artifact,
                            "--dtype", "bfloat16",
                            "--batch-sizes", ",".join(map(str, BUCKETS))])
    assert manifest["platform"] == "cuda", manifest
    pred = load_predictor(artifact)
    log(f"export + load {time.perf_counter() - t0:.1f} s")
    for b in BUCKETS:  # warm every bucket before counting
        pred.predict(np.zeros((b, 224, 224, 3), np.uint8))
    requests = [rs.randint(0, 256, (n, 224, 224, 3)).astype(np.uint8)
                for n in REQUESTS]
    server, batcher = make_server(pred, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        ops.reset_launch_counts()
        answers = [post(server.server_address[1], x) for x in requests]
        counts = ops.launch_counts()
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=30)
    forwards = sum(forwards_for(n) for n in REQUESTS)
    want = {k: v * forwards for k, v in PER_FORWARD.items()}
    log(f"launch counts over {forwards} forwards: {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    for x, logits in zip(requests, answers):
        if logits.shape != (len(x), 1000) or not np.isfinite(logits).all():
            raise AssertionError(f"bad logits {logits.shape} for {len(x)} images")
        direct = pred.predict(x)
        if not np.array_equal(logits, direct):
            raise AssertionError(f"HTTP logits differ from the Predictor's: "
                                 f"max |d| {np.abs(logits - direct).max()}")
    log(f"served requests of {list(REQUESTS)} images over HTTP: finite, "
        "(n, 1000), equal to Predictor.predict")
    return pred, requests[-1][:8], counts


def cross_check(artifact: str, pred, images: np.ndarray) -> None:
    import torch

    from slim_switch_moe_vit_tpu_torch import create_model
    from slim_switch_moe_vit_tpu_torch.serving.export import make_serve_fn

    model = create_model(MODEL, dtype=torch.float32).eval()
    model.load_state_dict(torch.load(os.path.join(artifact, "params.pt"),
                                     weights_only=True))
    ref = make_serve_fn(model)(torch.from_numpy(images)).numpy()
    got = pred.predict(images)
    d = np.abs(got - ref)
    tol = XCHECK_REL * np.abs(ref).max()
    cos = (got * ref).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(ref, axis=1)
    top2 = np.sort(ref, axis=1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > 2 * d.max()
    agree = got.argmax(1) == ref.argmax(1)
    log(f"cross-check vs CPU f32 plain path, {len(images)} images: max |d| "
        f"{d.max():.4e} (tol {tol:.4e}), max |ref| {np.abs(ref).max():.4e}, "
        f"min cosine {cos.min():.6f}, top-1 agree {int(agree.sum())}/"
        f"{len(images)} ({int(decisive.sum())} decisive, all must agree)")
    if d.max() > tol or cos.min() < XCHECK_COS or not agree[decisive].all():
        raise AssertionError("card bf16 logits disagree with the CPU f32 path")


def speed_phase(pred, card: str) -> None:
    import torch

    x32 = np.random.RandomState(5).randint(0, 256, (32, 224, 224, 3)).astype(np.uint8)
    for _ in range(3):
        pred.predict(x32)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.predict(x32)
    ips = 32 * reps / (time.perf_counter() - t0)
    x1 = x32[:1]
    lat = []
    for _ in range(50):
        t0 = time.perf_counter()
        pred.predict(x1)
        lat.append((time.perf_counter() - t0) * 1e3)
    log(f"serving: {ips:.1f} images/s at bucket 32 (Predictor.predict, host "
        f"clock, uint8 upload included), p50 latency at batch 1 "
        f"{statistics.median(lat):.3f} ms; card {card}")
    serve = pred.serve
    for B in (32, 128):
        xb = torch.from_numpy(np.random.RandomState(B).randint(
            0, 256, (B, 224, 224, 3)).astype(np.uint8)).cuda()
        ms = median_ms(lambda: serve(xb), reps=10)
        log(f"device forward B={B}: {ms:.3f} ms ({B / ms * 1e3:.1f} images/s "
            f"on the device clock); card {card}")
    profile_forward(serve, xb)


def profile_forward(serve, xb) -> None:
    """Device time of one forward by kernel name, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    serve(xb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(xb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for ev in prof.events():  # device-side events only: the kernels
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    rows = sorted(((us, n, name) for name, (us, n) in by_name.items()),
                  reverse=True)
    total = sum(r[0] for r in rows) / 1e3
    log(f"profile, one forward B={xb.shape[0]}: wall {wall_ms:.3f} ms, "
        f"device kernels {total:.3f} ms in {sum(r[1] for r in rows)} launches "
        f"(busy share {total / wall_ms:.3f})")
    for us, n, name in rows[:15]:
        log(f"  {us / 1e3:9.3f} ms {n:5d}x  {name[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA GPU", file=sys.stderr)
        return 1
    from slim_switch_moe_vit_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load_library()
    log(f"built CUDA kernels (nvcc, sm_90a) in {time.perf_counter() - t0:.1f} s")
    with open(os.path.join(os.path.dirname(_build.build()),
                           _build.PTXAS_LOG)) as f:
        for line in f:  # registers and spills of each kernel instance
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())

    results: dict = {}
    with torch.no_grad():
        kernel_phase(results)
    rs = np.random.RandomState(0)
    tmp = tempfile.mkdtemp(prefix="ssmv_smoke_")
    try:
        artifact = os.path.join(tmp, "artifact")
        pred, images, launches = serving_phase(artifact, rs)
        cross_check(artifact, pred, images)
        speed_phase(pred, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    summary = {"kernels": [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": launches[name], **results[name]}
        for name, route, source, replaces in KERNELS]}
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
