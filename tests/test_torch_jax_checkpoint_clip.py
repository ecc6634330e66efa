"""A JAX run with ``--clip-grad`` carried to the port: the chain's first
entry is ``clip_by_global_norm`` (no state), so the Adam entry the import
reads stands second. Two JAX steps, the import bit for bit, one more step
within the f32 parity limits (tests/jax_checkpoint_common.py)."""
import pytest
import torch

import jax_checkpoint_common as jc
from torch_tmp import delete_module_tmp, delete_tmp_path  # noqa: F401

CLIP = 0.5  # below the steps' global gradient norms: every step clips


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return jc.jax_run(tmp_path_factory.mktemp("jax_clip"), clip_grad=CLIP)


def test_the_adam_entry_is_not_first(run):
    chain = run["saved"].opt_state
    assert not hasattr(chain[0], "mu") and hasattr(chain[1], "mu")


def test_import_is_exact(run):
    jc.check_exact_import(run)


def test_one_more_step_matches_jax(run):
    jc.check_one_more_step(run)
