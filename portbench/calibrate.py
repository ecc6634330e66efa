"""Readings for setting a cell's limits: the check's numbers of the program
and of the control and planted faults, each against the reference, on the
card at the cell's own size, one JSON line per seed.

    python portbench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --sides program,control,half_batch

Sides: ``program``, ``control`` (the reference in fp8 products in the
program's place) and, by traffic kind, ``half_batch`` (training: the
reference in the program's place on each batch's first half) or
``altered`` (serving: one answer replaced by its neighbour's). The
benchmark's own runs never run these.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "portbench", ".cache",
                                              "triton")
os.environ["USE_FLAX"] = "0"

from portbench import harness  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sides", default="program,control")
    args = p.parse_args(argv)
    cell = harness.load("cells", args.workload)
    device = harness.card(int(cell["chips"]))
    if device is None:
        return 2
    sides = args.sides.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        run = harness.make_run(args.workload, seed, 0.0, False, device, t)
        out = harness.kind_module(run.traffic).readings(run, sides)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t,
                          "readings": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
