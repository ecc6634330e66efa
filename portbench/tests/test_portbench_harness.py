"""The harness on the CPU: its files agree with ``BENCHMARK.json``, a cell
and a metric added as files are found without an edit, nothing it loads is
JAX or the JAX package, and it refuses to measure without a card."""
from __future__ import annotations

import glob
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
from portbench_tiny import ROOT

from portbench import harness, readers
from portbench.counts import FUNCTIONS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = harness.names("cells")
METRICS = {n: harness.load("metrics", n) for n in harness.names("metrics")}


def _reported(cell: str):
    c = harness.load("cells", cell)
    return harness.end_to_end(harness.load("traffic", c["traffic"]))


def test_every_cell_names_a_configuration_and_a_traffic_kind():
    assert CELLS
    for name in CELLS:
        c = harness.load("cells", name)
        cfg = harness.load("configs", c["config"])
        traffic = harness.load("traffic", c["traffic"])
        assert cfg["model"] and traffic["kind"]
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "traffic", f"{traffic['kind']}.py"))
        assert c["chips"] in (1, 4) and 1 <= len(c["why"]) <= 200
        assert c["limits"], name


def test_benchmark_json_agrees_with_the_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert {w["name"] for w in BENCH["workloads"]} == set(CELLS)
    for w in BENCH["workloads"]:
        c = harness.load("cells", w["name"])
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            c["config"], c["traffic"], c["chips"], c["why"])
    for cfg in BENCH["configs"]:
        f = harness.load("configs", cfg["name"])
        assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
        assert cfg["source"] == f["source"] and cfg["reduced"] == f["reduced"]
    assert {m["name"] for m in BENCH["per_layer"]} == set(METRICS)
    for m in BENCH["per_layer"]:
        f = METRICS[m["name"]]
        for k in ("unit", "better", "source", "layer", "moves", "workloads"):
            assert m[k] == f[k], (m["name"], k)


def test_every_moves_is_reported_by_every_cell_that_reports_the_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for name, m in METRICS.items():
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in _reported(cell), (name, cell)
    for cell in CELLS:
        reported = _reported(cell)
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.metrics_for(cell, reported), cell
        for k in reported:
            cells = e2e[k].get("workloads")
            assert cells is None or cell in cells, (k, cell)


def test_names_and_units_use_the_allowed_characters():
    names = ([w["name"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [c["name"] for c in BENCH["configs"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units), units


def test_every_metric_names_a_reader_and_a_count_that_exist():
    for name, m in METRICS.items():
        assert m["reader"] in readers.READERS, name
        if m["reader"] == "roofline":
            assert m["count"] in FUNCTIONS and m["patterns"], name
            assert name.split(".")[0].endswith("_roofline")
            assert m["unit"] == "%"


def test_an_added_cell_and_metric_are_found_without_an_edit(tmp_path):
    copy = tmp_path / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench"), copy,
                    ignore=shutil.ignore_patterns(".cache", ".out",
                                                  "__pycache__"))
    cell = harness.load("cells", "moe_small_e8.train_b512")
    cell.pop("name")
    cell["traffic"] = "train_b64"
    (copy / "cells" / "moe_small_e8.train_b64.json").write_text(
        json.dumps(cell))
    traffic = harness.load("traffic", "train_b512")
    traffic.pop("name")
    traffic["batch"] = 64
    (copy / "traffic" / "train_b64.json").write_text(json.dumps(traffic))
    metric = dict(METRICS["optimizer_ms.train"], name=None,
                  workloads=["moe_small_e8.train_b64"])
    metric.pop("name")
    (copy / "metrics" / "adamw_ms.train.json").write_text(json.dumps(metric))
    code = ("from portbench import harness; "
            "c = 'moe_small_e8.train_b64'; "
            "r = harness.make_run(c, 1, 1.0, False, None, 0.0); "
            "print(c in harness.names('cells'), r.traffic['batch'], "
            "[m['name'] for m in harness.metrics_for(c, "
            "harness.end_to_end(r.traffic))])")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.stdout.split() == ["True", "64", "['adamw_ms.train']"]


GUARD = ("import sys, {mods}; "
         "print(sorted({{m.split('.')[0] for m in sys.modules}}))")


def _loaded(mods: str):
    out = subprocess.run([sys.executable, "-c", GUARD.format(mods=mods)],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(eval(out.stdout))


def test_the_harness_and_reference_load_no_jax():
    loaded = _loaded("portbench.harness, portbench.readers, portbench.check, "
                     "portbench.traffic.train, portbench.traffic.serve, "
                     "portbench.calibrate, portbench.reference.step")
    assert not loaded & set(harness.FORBIDDEN), loaded
    ref = _loaded("portbench.reference.model, portbench.reference.step")
    assert "slim_switch_moe_vit_tpu_torch" not in ref
    assert not ref & set(harness.FORBIDDEN)


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "slim_switch_moe_vit_tpu_torch_x",
                        sys.modules[__name__])
    assert "slim_switch_moe_vit_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.linen", sys.modules[__name__])
    assert "flax" in harness.forbidden_modules()


def test_the_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "moe_small_e8.train_b512", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_the_run_never_falls_back_to_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.card(1) is None
    assert harness.main(["--workload", "moe_small_e8.serve_b128", "--seed",
                         "1", "--seconds", "1"], 0.0) == 2


def test_no_test_file_repeats_a_name_under_tests():
    here = {os.path.basename(p) for p in glob.glob(
        os.path.join(ROOT, "portbench", "tests", "*.py"))}
    there = {os.path.basename(p) for p in glob.glob(
        os.path.join(ROOT, "tests", "*.py"))}
    assert not here & there


@pytest.mark.cuda
def test_a_short_run_on_the_card_prints_its_result_line():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "moe_small_e8.serve_b128", "--seed", "3000000099", "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"serve_images_per_s", "serve_p95_ms",
                                    "setup_s"}
