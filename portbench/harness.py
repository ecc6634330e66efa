"""The harness: finds a cell's files by name, runs its traffic kind on the
card, reads the per-layer metrics and prints the result line.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric is a file of its own, found by the name
``BENCHMARK.json`` gives:

- ``cells/<cell>.json``: its configuration, traffic mix, chips, why, and
  the limits of the numbers its check compares;
- ``configs/<config>.json``: the model's sizes and recipe, with source,
  ``reduced`` and ``assumed``;
- ``traffic/<mix>.json``: the mix's parameters, and its ``kind``, whose
  generator is ``traffic/<kind>.py``;
- ``metrics/<metric>.json``: its layer, unit, ``moves``, cells, and its
  reader (``readers.py``) with the reader's arguments.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import importlib
import json
import os
import subprocess
import sys
import typing as typ

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, ".out")
FORBIDDEN = ("jax", "jaxlib", "flax", "slim_switch_moe_vit_tpu")


def note(run: "Run", what: str) -> None:
    """A set-up phase's end, in seconds from the process's start, on
    standard error."""
    import time

    print(f"setup {what} {time.perf_counter() - run.started:.3f}",
          file=sys.stderr, flush=True)


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        data = json.load(f)
    data["name"] = name
    return data


def names(kind: str) -> typ.List[str]:
    return sorted(os.path.basename(p)[:-5]
                  for p in glob.glob(os.path.join(HERE, kind, "*.json")))


def kind_module(traffic: dict):
    return importlib.import_module(f"portbench.traffic.{traffic['kind']}")


def end_to_end(traffic: dict) -> typ.Dict[str, str]:
    """``{metric: unit}`` that a mix's kind reports."""
    return dict(kind_module(traffic).END_TO_END)


def metrics_for(cell: str, reported: typ.Iterable[str]) -> typ.List[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    that list no cells and move an end-to-end metric it reports."""
    reported = set(reported)
    out = []
    for name in names("metrics"):
        m = load("metrics", name)
        cells = m.get("workloads")
        if (cell in cells) if cells is not None else (m["moves"] in reported):
            out.append(m)
    return out


def forbidden_modules() -> typ.List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """One run of one cell."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    cfg: dict
    traffic: dict
    device: typ.Any
    started: float                 # perf_counter at the process's start
    out_dir: str = OUT


@dataclasses.dataclass
class Outcome:
    """What a traffic kind's run hands back."""
    end_to_end: typ.Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    numbers: typ.Dict[str, float]
    window: typ.Any = None         # readers.Window of the traced window


def make_run(workload: str, seed: int, seconds: float, trace: bool,
             device, started: float) -> Run:
    cell = load("cells", workload)
    return Run(workload=workload, seed=seed, seconds=seconds, trace=trace,
               cell=cell, cfg=load("configs", cell["config"]),
               traffic=load("traffic", cell["traffic"]), device=device,
               started=started)


def peak_rates(device) -> dict:
    """The card's peak rates from ``peaks.json``, by its name."""
    import torch

    with open(os.path.join(HERE, "peaks.json")) as f:
        table = json.load(f)
    kind = torch.cuda.get_device_name(device)
    for key, row in table.items():
        if key in kind:
            return row
    raise ValueError(f"no peak rates for {kind!r} in peaks.json")


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def result_line(run: Run, outcome: Outcome, checks: typ.Dict[str, dict],
                correct: bool) -> dict:
    import torch

    from . import readers

    line: typ.Dict[str, typ.Any] = {
        "correct": correct, "attempted": outcome.attempted,
        "failed": outcome.failed, "metrics": {}}
    units = end_to_end(run.traffic)
    if not run.trace:
        for k, unit in units.items():
            line["metrics"][k] = {"value": outcome.end_to_end[k], "unit": unit}
    else:
        for m in metrics_for(run.workload, units):
            v = readers.read(m, outcome.window)
            if v is not None:
                line["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    line["device"] = {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": int(run.cell["chips"]),
        "memory_peak_bytes": int(outcome.memory_peak_bytes),
        "power_limit": power_limit()}
    if run.trace:
        tr = outcome.window.trace
        line["device"]["busy_s"] = tr.busy_s
        line["device"]["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": tr.idle_gaps()}
    line["checks"] = checks
    return line


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell on the "
                                "card this process starts on.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card(chips: int):
    """The card to measure on, or None (with the reason on stderr) where
    there is none or too few: the benchmark never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; refusing to measure",
              file=sys.stderr)
        return None
    if torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return None
    return torch.device("cuda", 0)


def execute(run: Run) -> typ.Tuple[dict, typ.Dict[str, dict]]:
    """Run the cell and judge it: (result line, checks)."""
    from . import check

    outcome = kind_module(run.traffic).run(run)
    ok, checks = check.judge(outcome.numbers, run.cell["limits"])
    correct = ok and outcome.failed == 0 and outcome.attempted > 0
    return result_line(run, outcome, checks, correct), checks


def main(argv, started: float) -> int:
    args = parse(argv)
    cell = load("cells", args.workload)
    device = card(int(cell["chips"]))
    if device is None:
        return 2
    run = make_run(args.workload, args.seed, args.seconds, bool(args.trace),
                   device, started)
    line, checks = execute(run)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}; "
              "the benchmark runs without JAX and the JAX package",
              file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for k, r in checks.items():
        print(f"check {k} {r['value']!r} limit {r['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0
