"""A JAX run of ``--opt sgd`` (Nesterov, momentum 0.9) carried to the
port: the chain's ``trace`` becomes ``torch.optim.SGD``'s
``momentum_buffer``. Two JAX steps, the import bit for bit, one more step
within the f32 parity limits (tests/jax_checkpoint_common.py)."""
import pytest
import torch

import jax_checkpoint_common as jc
from torch_tmp import delete_module_tmp, delete_tmp_path  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return jc.jax_run(tmp_path_factory.mktemp("jax_sgd"), opt="sgd")


def test_import_is_exact(run):
    jc.check_exact_import(run)


def test_one_more_step_matches_jax(run):
    jc.check_one_more_step(run)
