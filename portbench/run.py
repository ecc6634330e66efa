"""Run one benchmark cell on the card this process starts on.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the last lines of standard error are the numbers the check
compared, each beside its limit. Exits non-zero and prints no result
without a CUDA card.
"""
import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # the checkout, not this directory, is the import root
# every kernel cache of the program inside the checkout, at a fixed path
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "portbench", ".cache",
                                              "triton")
os.environ["USE_FLAX"] = "0"

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], STARTED))
