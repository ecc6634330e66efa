"""Shared pieces of the tests that run the port's training driver on gloo
ranks of this host (``tests/test_torch_ep_driver*.py``): each rank is a
``python -m slim_switch_moe_vit_tpu_torch.main`` process with torchrun's
environment and a ``file://`` rendezvous under the test's directory."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--data-set", "SYNTH", "--synth-size", "24",
         "--input-size", "32", "--model", "resmoe_tiny_patch16_224_expert8",
         "--num-experts", "4", "--batch-size", "4", "--epochs", "1",
         "--max-steps-per-epoch", "1", "--no-repeated-aug", "--mixup", "0",
         "--cutmix", "0", "--aa", "", "--color-jitter", "0", "--reprob", "0",
         "--num_workers", "1"]


def run_ranks(argv, world: int, out_dir, env=None, timeout=300):
    """Run the driver on ``world`` ranks; returns each rank's output.
    Raises if a rank fails."""
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(str(out_dir), "store")
    procs = []
    for r in range(world):
        penv = {**os.environ, **(env or {}), "RANK": str(r),
                "WORLD_SIZE": str(world), "LOCAL_RANK": str(r),
                "LOCAL_WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1",
                "PYTHONPATH": REPO}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "slim_switch_moe_vit_tpu_torch.main",
             *argv, "--output_dir", str(out_dir), "--dist_url",
             f"file://{store}"],
            env=penv, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}"
    return outs
