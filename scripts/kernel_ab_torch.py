"""Compare the port's kernel times on the card between two source trees.

Runs ``chip_smoke.py``'s kernel, capacity kernel, EP kernel and coverage
kernel phases (every kernel wrapper against its plain version, timed with
CUDA events; K8 and K9 at cfg4's and the dropless layouts, K10 at ep=4's)
in each tree, in the order A, B, B, A on one card, and prints each timed key of
each kernel as the four runs and B's change against A (the mean of B's two
runs over the mean of A's). Each run is a fresh process that builds its
tree's kernels. Usage, from the repository root on a machine with one GPU:

    python3 scripts/kernel_ab_torch.py <tree A> <tree B> --out DIR \
        [--phases kernel,capacity,ep,coverage]

where a tree is a checkout holding ``chip_smoke.py`` and the port (for
example the parent commit unpacked by ``git archive``), and ``--phases``
names the phases to run (all four by default; ``coverage`` alone holds the
f32 attention and expert-FFN cases). A timed key that only B's phases
record (a case B adds) prints B's two runs. The runs' logs and results go
to DIR.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PHASES = """
import json, sys, torch, chip_smoke as s
from slim_switch_moe_vit_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.load_library()
r = {}
todo = sys.argv[2].split(",")
if "kernel" in todo:
    s.kernel_phase(r)
if "capacity" in todo:
    s.capacity_kernel_phase(r)
if "ep" in todo:
    s.ep_kernel_phase(r, s.card_line())
if "coverage" in todo:
    s.coverage_kernel_phase(r)
json.dump(r, open(sys.argv[1], "w"))
"""


def run(tree: str, out: str, tag: str, phases: str) -> dict:
    path = os.path.join(out, f"ab_{tag}.json")
    with open(os.path.join(out, f"ab_{tag}.log"), "w") as log:
        subprocess.run([sys.executable, "-c", PHASES, path, phases],
                       cwd=tree, stdout=log, stderr=subprocess.STDOUT,
                       check=True)
    with open(path) as f:
        return json.load(f)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--out", required=True,
                    help="directory for the runs' logs and results")
    ap.add_argument("--phases", default="kernel,capacity,ep,coverage",
                    help="comma-separated phases to run")
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    order = (("a1", args.tree_a), ("b1", args.tree_b), ("b2", args.tree_b),
             ("a2", args.tree_a))
    res = {tag: run(os.path.abspath(tree), out, tag, args.phases)
           for tag, tree in order}
    for name in res["b1"]:
        for key in sorted(res["b1"][name]):
            vals = [res[tag].get(name, {}).get(key) for tag, _ in order]
            if not key.startswith("ms"):
                continue
            if vals[0] is None and vals[3] is None and all(
                    isinstance(v, float) for v in vals[1:3]):
                # a case only B's phases run
                print(f"{name:30s} {key:14s} - {vals[1]:.4f} {vals[2]:.4f} -"
                      "  B only")
                continue
            if not all(isinstance(v, float) for v in vals) or not (
                    vals[0] + vals[3]):
                continue
            change = (vals[1] + vals[2]) / (vals[0] + vals[3]) - 1
            print(f"{name:30s} {key:14s} "
                  + " ".join(f"{v:.4f}" for v in vals)
                  + f"  B vs A {change * 100:+.1f}%")


if __name__ == "__main__":
    main()
